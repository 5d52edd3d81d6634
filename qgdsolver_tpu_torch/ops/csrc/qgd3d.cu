// Hand-written Hopper (sm_90a) kernels for one explicit 3D QGDFoam step.
//
// Replaces the TPU kernel qgdsolver_tpu/ops/fused_qgd3d.py::
// build_fused_step_3d (the x-slab Pallas kernel at :349) together with its
// XLA dt pre-pass (`_dt_prepass`, :664).  The TPU kernel walks x-slabs in
// order on one core with a frame-wide dt taken before it; blocks on a GPU run
// in no order and cannot wait for each other, so the step is four launches
// on the caller's stream, with dt kept on the device:
//
//   qgd3d_dt      two-pass reduction: per-block max wave speed per axis and
//                 min face tau, then one block applies setDeltaT;
//   qgd3d_update  one thread per interior cell rebuilds its six face fluxes
//                 (jm, Pi, q with the `full` tangential differences) and
//                 writes fresh p, T, ux, uy, uz into NEW frames, plus
//                 ws/tau_f on the two x-boundary faces (the qgdFlux ghost);
//   qgd3d_sensor  varScModel5 only: the raw sensor over the fresh frames.  A
//                 launch of its own, because it reads fresh rho at cells that
//                 other blocks of the update write;
//   qgd3d_ghosts  x-ghost planes from the fresh interior, then y-ghost rows
//                 over every x, then z-ghost lanes over every x and y (three
//                 launches: the sequential-axis padding, edges included).
//
// The x-ring decomposition K5 (build_sharded_fused_step_3d, :930) runs the
// same kernels on each rank's x-slab, whose x ends may be partition planes:
// there the halo plane holds the neighbour's true cells, and the flags
// edge_lo / edge_hi of QGD3DParams (1: a physical boundary) make the
// kernels read it as it is: no zero-gradient coefficient ghost, no tau
// clamp in qgd3d_dt, no qgdFlux side plane, no x-ghost plane (the plane
// exchange fills it), and the sensor's x-gradient reads the exchanged
// plane (qgd3d_sensor runs after the exchange).  The serial builders set
// both flags to 1.  dt over the ranks: qgd3d_dt_fold, a MAX all-reduce of
// its quad (max wave x, y, z, -min tau), then qgd3d_dt_apply.
//
// Frames are contiguous (nx+2, ny+2, nz+2) float32 with z the fast axis, so a
// warp reads 32 neighbouring z cells of one (x, y) line.  What bounds the
// step is memory and registers: at least 5 frames in and 5 out (+ the sensor
// frame for varScModel5), ~40-44 B per cell, and a face body three times
// the 2D one.  This first version reads each face's ten cells straight from
// global memory (L1/L2 absorb the re-reads) and computes every face twice,
// once for each cell beside it; shared-memory plane tiles, a column march
// along x and single evaluation of faces come in a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum { BC_ZG = 0, BC_FIXED = 1, BC_GRAD = 2, BC_SYM = 3, BC_EXTRAP = 4,
       BC_IO = 5, BC_QGDFLUX = 6 };

constexpr int BX = 32;   // threads along z
constexpr int BY = 8;    // threads along y
constexpr int RED = 256; // threads of the final dt reduction
constexpr int GT = 128;  // threads of a ghost launch

}  // namespace

// One ghost spec, as in qgd2d.cu: kind, scalar value (the sign for
// symmetry), index of a (ny, nz) plane profile (-1: none).  Mirrored by
// ops/_build.py::BCEntry.
struct BCEntry3 {
  int kind;
  float value;
  int prof;
};

// Step constants, passed by value.  Mirrored by ops/_build.py::QGD3DParams.
struct QGD3DParams {
  int nx, ny, nz, varsc, mu_const0, adjust_dt;
  int edge_lo, edge_hi;  // 1 where an x end is a physical boundary
  float d[3], inv_d[3], inv_2d[3], area[3];
  float inv_vol, R, Cv, inv_Cv, CvR, gammaR, gamma, alpha, k_mu, k_muv;
  float inv_Pr_tau, mu0, mu0_Pr_th, max_co, max_dt, c_tau;
  float rC, one_m_rC, minSc, maxSc, cqSc, h_cell;
  BCEntry3 bc[5][3][2];  // [field p, T, ux, uy, uz][axis][side]
};

namespace {

struct Frames {
  const float* __restrict__ p;
  const float* __restrict__ T;
  const float* __restrict__ u[3];
};

struct Cell {
  float p, T, rho, e, u[3];
};

struct Coef {
  float mu;  // mu_eff
  float au;  // alphau_eff (unused when the molecular mu is 0)
  float tc;  // tau coefficient: alpha/c (constScPr family) or c (varScModel5)
};

struct Flux {
  float f[5];  // rho, m0, m1, m2, E (area included)
  float ws, tau;
};

__device__ __forceinline__ float xi(float a, float b) { return 0.5f * (a + b); }

__device__ __forceinline__ Cell load_cell(const QGD3DParams& P,
                                          const Frames& F, long i) {
  Cell c;
  c.p = F.p[i];
  c.T = F.T[i];
  c.rho = c.p / (P.R * c.T);
  c.e = P.Cv * c.T;
#pragma unroll
  for (int j = 0; j < 3; ++j) c.u[j] = F.u[j][i];
  return c;
}

// Coefficient fields of one cell; one rsqrt feeds c, alpha/c and mu.
__device__ __forceinline__ Coef cell_coef(const QGD3DParams& P, float p,
                                          float T, float sc) {
  const float gRT = P.gammaR * T;
  const float rcs = rsqrtf(gRT);
  Coef k;
  k.tc = P.varsc ? gRT * rcs : P.alpha * rcs;
  const float mu = P.varsc ? ((P.k_muv * sc) * p) * rcs : (P.k_mu * p) * rcs;
  if (P.mu_const0) {
    k.mu = mu;
    k.au = 0.0f;
  } else {
    k.au = mu * P.inv_Pr_tau + P.mu0_Pr_th;
    k.mu = mu + P.mu0;
  }
  return k;
}

// The face between cell A (index ia) and B = A + e_AX, whose coefficients
// are kA, kB.  st[] are the index strides of the three axes.  Mirrors the
// per-axis body of the reference kernel (fused_qgd3d.py:446-521).
template <int AX>
__device__ Flux face_flux(const QGD3DParams& P, const Frames& F, long ia,
                          const long st[3], const Coef& kA, const Coef& kB) {
  constexpr int B1 = AX == 0 ? 1 : 0;
  constexpr int B2 = AX == 2 ? 1 : 2;
  const long ib = ia + st[AX];
  const Cell A = load_cell(P, F, ia);
  const Cell B = load_cell(P, F, ib);

  const float pf = xi(A.p, B.p);
  const float rf = xi(A.rho, B.rho);
  float uf[3], ruf[3], urr[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uf[j] = xi(A.u[j], B.u[j]);
    ruf[j] = xi(A.rho * A.u[j], B.rho * B.u[j]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    urr[k] = xi(A.u[AX] * (A.rho * A.u[k]), B.u[AX] * (B.rho * B.u[k]));
  const float keA = A.u[0] * A.u[0] + A.u[1] * A.u[1] + A.u[2] * A.u[2];
  const float keB = B.u[0] * B.u[0] + B.u[1] * B.u[1] + B.u[2] * B.u[2];
  const float Hf = xi(P.CvR * A.T + 0.5f * keA, P.CvR * B.T + 0.5f * keB);
  const float muf = xi(kA.mu, kB.mu);
  const float af = P.mu_const0 ? muf * P.inv_Pr_tau : xi(kA.au, kB.au);
  const float tauf = P.varsc ? (P.alpha / xi(kA.tc, kB.tc)) * P.d[AX]
                             : xi(kA.tc, kB.tc) * P.d[AX];

  // gradients at the face: gU[i][j] = dU_j/dx_i
  float gU[3][3], gR[3], gP[3], ge[3];
  const float ia_d = P.inv_d[AX];
#pragma unroll
  for (int j = 0; j < 3; ++j) gU[AX][j] = (B.u[j] - A.u[j]) * ia_d;
  gR[AX] = (B.rho - A.rho) * ia_d;
  gP[AX] = (B.p - A.p) * ia_d;
  ge[AX] = (B.e - A.e) * ia_d;
  // tangential: central difference of the face values along each other axis
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int b = n == 0 ? B1 : B2;
    const Cell Ap = load_cell(P, F, ia + st[b]);
    const Cell Bp = load_cell(P, F, ib + st[b]);
    const Cell Am = load_cell(P, F, ia - st[b]);
    const Cell Bm = load_cell(P, F, ib - st[b]);
    const float h = P.inv_2d[b];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gU[b][j] = (xi(Ap.u[j], Bp.u[j]) - xi(Am.u[j], Bm.u[j])) * h;
    gR[b] = (xi(Ap.rho, Bp.rho) - xi(Am.rho, Bm.rho)) * h;
    gP[b] = (xi(Ap.p, Bp.p) - xi(Am.p, Bm.p)) * h;
    ge[b] = (xi(Ap.e, Bp.e) - xi(Am.e, Bm.e)) * h;
  }

  const float divU = gU[0][0] + gU[1][1] + gU[2][2];
  const float u_gradrho = uf[0] * gR[0] + uf[1] * gR[1] + uf[2] * gR[2];
  const float rg = ruf[0] * gU[0][AX] + ruf[1] * gU[1][AX] + ruf[2] * gU[2][AX];
  const float ws = tauf * (u_gradrho * uf[AX] + ruf[AX] * divU + rg);
  const float jm = ruf[AX] - (ws + tauf * gP[AX]);
  const float u_gradp = uf[0] * gP[0] + uf[1] * gP[1] + uf[2] * gP[2];
  const float iso = u_gradp + P.gamma * pf * divU;
  float pi[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float t1 = urr[0] * gU[0][j] + urr[1] * gU[1][j] +
                     urr[2] * gU[2][j] + uf[AX] * gP[j];
    if (j == AX)
      pi[j] = tauf * (t1 + iso) +
              muf * (gU[AX][j] + gU[j][AX] - (2.0f / 3.0f) * divU);
    else
      pi[j] = tauf * t1 + muf * (gU[AX][j] + gU[j][AX]);
  }
  const float prr = pf / (rf * rf);
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) q += urr[k] * (ge[k] - prr * gR[k]);
  q = -tauf * q - af * ge[AX];

  const float area = P.area[AX];
  const float phiJm = jm * area;
  Flux fl;
  fl.f[0] = phiJm;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    fl.f[1 + j] = phiJm * uf[j] + area * ((j == AX ? pf : 0.0f) - pi[j]);
  fl.f[4] = phiJm * Hf +
            area * (q - (pi[0] * uf[0] + pi[1] * uf[1] + pi[2] * uf[2]));
  fl.ws = ws;
  fl.tau = tauf;
  return fl;
}

// The face tau coefficient of one cell from its T: alpha/c or c.
__device__ __forceinline__ float tau_coef(const QGD3DParams& P, float T) {
  const float g = P.gammaR * T;
  const float c = g * rsqrtf(g);
  return P.varsc ? c : P.alpha / c;
}

__device__ __forceinline__ float face_tau(const QGD3DParams& P, float ta,
                                          float tb, int ax) {
  return P.varsc ? (P.alpha / xi(ta, tb)) * P.d[ax] : xi(ta, tb) * P.d[ax];
}

__device__ __forceinline__ float wave(const QGD3DParams& P, float uA,
                                      float uB, float TA, float TB) {
  const float gA = P.gammaR * TA, gB = P.gammaR * TB;
  return fabsf(xi(uA, uB)) + xi(gA * rsqrtf(gA), gB * rsqrtf(gB));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Pass 1: thread (r, s, t), each in 0..n, owns the x-face r+1/2 at (s, t)
// when s, t >= 1, the y-face s+1/2 at (r, t) when r, t >= 1 and the z-face
// t+1/2 at (r, s) when r, s >= 1: exactly the live face sets of the
// reference's pre-pass.  Per-block partials: max wave x, y, z; min tau_f.
__global__ void __launch_bounds__(BX * BY)
qgd3d_dt_partial_kernel(QGD3DParams P, const float* __restrict__ T,
                        const float* __restrict__ ux,
                        const float* __restrict__ uy,
                        const float* __restrict__ uz,
                        float* __restrict__ partials) {
  __shared__ float sm[4][BX * BY];
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int t = blockIdx.x * BX + threadIdx.x;
  const int s = blockIdx.y * BY + threadIdx.y;
  const int r = blockIdx.z;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * (nz + 2);
  float m[3] = {-INFINITY, -INFINITY, -INFINITY};
  float tmin = INFINITY;
  if (s <= ny && t <= nz) {
    const long i = r * sx + s * sy + t;
    if (s >= 1 && t >= 1) {
      m[0] = wave(P, ux[i], ux[i + sx], T[i], T[i + sx]);
      // zero-gradient coefficient ghosts at physical x ends only
      const long ra = r < 1 && P.edge_lo ? 1 : r;
      const long rb = r + 1 > nx && P.edge_hi ? nx : r + 1;
      const long ac = ra * sx + s * sy + t;
      const long bc = rb * sx + s * sy + t;
      tmin = face_tau(P, tau_coef(P, T[ac]), tau_coef(P, T[bc]), 0);
    }
    if (r >= 1 && t >= 1) {
      m[1] = wave(P, uy[i], uy[i + sy], T[i], T[i + sy]);
      const long ac = r * sx + clampi(s, 1, ny) * sy + t;
      const long bc = r * sx + clampi(s + 1, 1, ny) * sy + t;
      tmin = fminf(tmin, face_tau(P, tau_coef(P, T[ac]), tau_coef(P, T[bc]),
                                  1));
    }
    if (r >= 1 && s >= 1) {
      m[2] = wave(P, uz[i], uz[i + 1], T[i], T[i + 1]);
      const long ac = r * sx + s * sy + clampi(t, 1, nz);
      const long bc = r * sx + s * sy + clampi(t + 1, 1, nz);
      tmin = fminf(tmin, face_tau(P, tau_coef(P, T[ac]), tau_coef(P, T[bc]),
                                  2));
    }
  }
  sm[0][tid] = m[0];
  sm[1][tid] = m[1];
  sm[2][tid] = m[2];
  sm[3][tid] = tmin;
  __syncthreads();
  for (int k = BX * BY / 2; k > 0; k >>= 1) {
    if (tid < k) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        sm[a][tid] = fmaxf(sm[a][tid], sm[a][tid + k]);
      sm[3][tid] = fminf(sm[3][tid], sm[3][tid + k]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long bid =
        ((long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
    for (int a = 0; a < 4; ++a) partials[4 * bid + a] = sm[a][0];
  }
}

// Pass 2: one block folds the partials and applies setDeltaT (immediate
// reduction, damped increase, cTau*min(tau_f) and maxDeltaT caps).  Mode
// DT_FOLD writes the fold as the quad (max wave x, y, z, -min tau) to out
// instead; mode DT_APPLY applies setDeltaT to one reduced quad (n = 1).
enum { DT_FULL = 0, DT_FOLD = 1, DT_APPLY = 2 };

__global__ void __launch_bounds__(RED)
qgd3d_dt_final_kernel(QGD3DParams P, const float* __restrict__ partials,
                      long n, int mode, const float* __restrict__ dt_old,
                      float* __restrict__ out) {
  __shared__ float sm[4][RED];
  const int tid = threadIdx.x;
  const float tsign = mode == DT_APPLY ? -1.0f : 1.0f;
  float m[3] = {-INFINITY, -INFINITY, -INFINITY};
  float tmin = INFINITY;
  for (long i = tid; i < n; i += RED) {
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = fmaxf(m[a], partials[4 * i + a]);
    tmin = fminf(tmin, tsign * partials[4 * i + 3]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) sm[a][tid] = m[a];
  sm[3][tid] = tmin;
  __syncthreads();
  for (int k = RED / 2; k > 0; k >>= 1) {
    if (tid < k) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        sm[a][tid] = fmaxf(sm[a][tid], sm[a][tid + k]);
      sm[3][tid] = fminf(sm[3][tid], sm[3][tid + k]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (mode == DT_FOLD) {
#pragma unroll
      for (int a = 0; a < 3; ++a) out[a] = sm[a][0];
      out[3] = -sm[3][0];
      return;
    }
    const float dtv = dt_old[0];
    if (!P.adjust_dt) {
      out[0] = dtv;
      return;
    }
    // explicit roundings: no FMA contraction in the controller
    float co = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      co = fmaxf(co, __fdiv_rn(__fmul_rn(sm[a][0], dtv), P.d[a]));
    const float max_fact = __fdiv_rn(P.max_co, __fadd_rn(co, 1e-30f));
    const float fact = fminf(
        fminf(max_fact, __fadd_rn(1.0f, __fmul_rn(0.1f, max_fact))), 1.2f);
    const float max_dt1 = fminf(P.max_dt, __fmul_rn(P.c_tau, sm[3][0]));
    out[0] = fminf(__fmul_rn(fact, dtv), max_dt1);
  }
}

// One thread per interior cell (r, s, t): blockIdx.z + 1 = r, y and z from
// the block's (BY, BX) tile.
__global__ void __launch_bounds__(BX * BY)
qgd3d_update_kernel(QGD3DParams P, Frames F, const float* __restrict__ sc,
                    const float* __restrict__ dt, float* __restrict__ pn,
                    float* __restrict__ Tn, float* __restrict__ uxn,
                    float* __restrict__ uyn, float* __restrict__ uzn,
                    float* __restrict__ side) {
  const int t = 1 + blockIdx.x * BX + threadIdx.x;
  const int s = 1 + blockIdx.y * BY + threadIdx.y;
  const int r = 1 + blockIdx.z;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  if (s > ny || t > nz) return;
  const long st[3] = {(long)(ny + 2) * (nz + 2), nz + 2, 1};
  const long i0 = r * st[0] + s * st[1] + t;
  const int pos[3] = {r, s, t};
  const int n[3] = {nx, ny, nz};

  // coefficient fields take zero-gradient ghosts at physical boundaries: a
  // neighbour outside the interior is the centre cell itself; across a
  // partition plane it is the halo cell
  const int open_lo[3] = {!P.edge_lo, 0, 0};
  const int open_hi[3] = {!P.edge_hi, 0, 0};
  const float p0 = F.p[i0];
  const Coef k0 = cell_coef(P, p0, F.T[i0], P.varsc ? sc[i0] : 0.0f);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ws_lo = 0.0f, ws_hi = 0.0f, tau_lo = 1.0f, tau_hi = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const long im = i0 - st[a], ip = i0 + st[a];
    const Coef km = pos[a] > 1 || open_lo[a]
        ? cell_coef(P, F.p[im], F.T[im], P.varsc ? sc[im] : 0.0f) : k0;
    const Coef kp = pos[a] < n[a] || open_hi[a]
        ? cell_coef(P, F.p[ip], F.T[ip], P.varsc ? sc[ip] : 0.0f) : k0;
    Flux lo, hi;
    if (a == 0) {
      lo = face_flux<0>(P, F, im, st, km, k0);
      hi = face_flux<0>(P, F, i0, st, k0, kp);
      ws_lo = lo.ws; tau_lo = lo.tau; ws_hi = hi.ws; tau_hi = hi.tau;
    } else if (a == 1) {
      lo = face_flux<1>(P, F, im, st, km, k0);
      hi = face_flux<1>(P, F, i0, st, k0, kp);
    } else {
      lo = face_flux<2>(P, F, im, st, km, k0);
      hi = face_flux<2>(P, F, i0, st, k0, kp);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float dfl = hi.f[k] - lo.f[k];
      acc[k] = a == 0 ? dfl : acc[k] + dfl;
    }
  }

  const Cell o = load_cell(P, F, i0);
  const float sdt = dt[0] * P.inv_vol;
  const float rho = o.rho;
  const float ke = o.u[0] * o.u[0] + o.u[1] * o.u[1] + o.u[2] * o.u[2];
  const float rhoE = rho * (o.e + 0.5f * ke);
  const float rhon = rho - sdt * acc[0];
  const float inv_rhon = 1.0f / rhon;
  float un[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    un[j] = (rho * o.u[j] - sdt * acc[1 + j]) * inv_rhon;
  const float rhoEn = rhoE - sdt * acc[4];
  const float en =
      rhoEn * inv_rhon - 0.5f * (un[0] * un[0] + un[1] * un[1] + un[2] * un[2]);
  const float Tv = en * P.inv_Cv;
  pn[i0] = rhon * P.R * Tv;
  Tn[i0] = Tv;
  uxn[i0] = un[0];
  uyn[i0] = un[1];
  uzn[i0] = un[2];
  // ws/tau_f on the physical x-boundary faces: the qgdFlux p ghost of this
  // step
  const long j = (long)(s - 1) * nz + (t - 1);
  if (r == 1 && P.edge_lo) side[j] = ws_lo / tau_lo;
  if (r == nx && P.edge_hi) side[(long)ny * nz + j] = ws_hi / tau_hi;
}

// The raw varScModel5 sensor of the fresh frames at each interior cell: rho
// from the stored p, T; zero-gradient ghosts (clamped neighbours) at
// physical boundaries, the exchanged halo plane across a partition plane;
// relaxed against the current smoothed sensor.  Output (nx, ny, nz).
__global__ void __launch_bounds__(BX * BY)
qgd3d_sensor_kernel(QGD3DParams P, const float* __restrict__ p,
                    const float* __restrict__ T, const float* __restrict__ sc,
                    float* __restrict__ out) {
  const int t = 1 + blockIdx.x * BX + threadIdx.x;
  const int s = 1 + blockIdx.y * BY + threadIdx.y;
  const int r = 1 + blockIdx.z;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  if (s > ny || t > nz) return;
  const long st[3] = {(long)(ny + 2) * (nz + 2), nz + 2, 1};
  const long i0 = r * st[0] + s * st[1] + t;
  // rho of a neighbour; outside the interior the cell itself
  auto rho_at = [&](bool inside, long off) {
    const long i = inside ? i0 + off : i0;
    return p[i] * (1.0f / (P.R * T[i]));
  };
  const float r0 = rho_at(false, 0);
  const float gx = (rho_at(r < nx || !P.edge_hi, st[0]) -
                    rho_at(r > 1 || !P.edge_lo, -st[0])) * P.inv_2d[0];
  const float gy =
      (rho_at(s < ny, st[1]) - rho_at(s > 1, -st[1])) * P.inv_2d[1];
  const float gz = (rho_at(t < nz, 1) - rho_at(t > 1, -1)) * P.inv_2d[2];
  const float g2 = gx * gx + gy * gy + gz * gz;
  float v = P.rC * ((sqrtf(g2) * P.h_cell) / r0) + P.one_m_rC * sc[i0];
  v = fminf(fmaxf(v, P.minSc), P.maxSc);
  out[((long)(r - 1) * ny + (s - 1)) * nz + (t - 1)] = fmaxf(v, P.cqSc);
}

__device__ __forceinline__ float bc_ghost(const BCEntry3& b, float in1,
                                          float in2, float d, float v,
                                          float un, int sd) {
  switch (b.kind) {
    case BC_SYM:
      return b.value * in1;
    case BC_EXTRAP:
      return 2.0f * in1 - in2;
    case BC_FIXED:
      return 2.0f * v - in1;
    case BC_IO: {
      // inletOutlet: zeroGradient where the flow leaves, fixedValue where
      // it enters
      const bool outflow = sd == 0 ? (un < 0.0f) : (un > 0.0f);
      return outflow ? in1 : 2.0f * v - in1;
    }
    case BC_GRAD:
      return in1 + v * d;
    default:  // BC_ZG
      return in1;
  }
}

struct OutFrames {
  float* f[5];  // p, T, ux, uy, uz
};

// The frame of field f (a switch, so that no frame table goes to the stack).
__device__ __forceinline__ float* field_ptr(const OutFrames& O, int f) {
  switch (f) {
    case 0: return O.f[0];
    case 1: return O.f[1];
    case 2: return O.f[2];
    case 3: return O.f[3];
    default: return O.f[4];
  }
}

// Phase 0: x-ghost planes 0 and nx+1 at (s, t) in 1..ny x 1..nz.
// blockIdx.y = 2*field + side.  A partition end is skipped: the plane
// exchange fills it (y and z ghosts included, so phases 1-2 on a halo plane
// compute values the exchange overwrites).
__global__ void qgd3d_ghost_x_kernel(QGD3DParams P,
                                     const float* __restrict__ planes,
                                     const float* __restrict__ side,
                                     OutFrames O) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.y >> 1, sd = blockIdx.y & 1;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long plane = (long)ny * nz;
  if (k >= plane || !(sd == 0 ? P.edge_lo : P.edge_hi)) return;
  const int s = 1 + (int)(k / nz), t = 1 + (int)(k % nz);
  const long sx = (long)(ny + 2) * (nz + 2);
  const long c = s * (long)(nz + 2) + t;
  float* fld = field_ptr(O, f);
  const int r1 = sd == 0 ? 1 : nx;
  const int r2 = sd == 0 ? 2 : nx - 1;
  const int rg = sd == 0 ? 0 : nx + 1;
  const BCEntry3 b = P.bc[f][0][sd];
  const float in1 = fld[r1 * sx + c];
  float g;
  if (b.kind == BC_QGDFLUX) {
    const float q = side[sd * plane + k] * P.d[0];
    g = sd == 0 ? in1 + q : in1 - q;
  } else {
    const float v = b.prof >= 0 ? planes[b.prof * plane + k] : b.value;
    g = bc_ghost(b, in1, fld[r2 * sx + c], P.d[0], v, O.f[2][r1 * sx + c], sd);
  }
  fld[rg * sx + c] = g;
}

// Phase 1: y-ghost rows 0 and ny+1 at (r, t) in 0..nx+1 x 1..nz (reads the
// x-ghost planes of phase 0: the x-y edges).
__global__ void qgd3d_ghost_y_kernel(QGD3DParams P, OutFrames O) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.y >> 1, sd = blockIdx.y & 1;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  if (k >= (long)(nx + 2) * nz) return;
  const int r = (int)(k / nz), t = 1 + (int)(k % nz);
  const long sx = (long)(ny + 2) * (nz + 2), sy = nz + 2;
  float* fld = field_ptr(O, f);
  const int l1 = sd == 0 ? 1 : ny;
  const int l2 = sd == 0 ? 2 : ny - 1;
  const int lg = sd == 0 ? 0 : ny + 1;
  const BCEntry3 b = P.bc[f][1][sd];
  const long row = r * sx + t;
  // inletOutlet on the x-ghost planes switches on the edge interior plane
  const float un = O.f[3][clampi(r, 1, nx) * sx + l1 * sy + t];
  fld[row + lg * sy] = bc_ghost(b, fld[row + l1 * sy], fld[row + l2 * sy],
                                P.d[1], b.value, un, sd);
}

// Phase 2: z-ghost lanes 0 and nz+1 at (r, s) in 0..nx+1 x 0..ny+1 (reads
// phases 0 and 1: the x-z and y-z edges and the corners).
__global__ void qgd3d_ghost_z_kernel(QGD3DParams P, OutFrames O) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.y >> 1, sd = blockIdx.y & 1;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  if (k >= (long)(nx + 2) * (ny + 2)) return;
  const int r = (int)(k / (ny + 2)), s = (int)(k % (ny + 2));
  const long sx = (long)(ny + 2) * (nz + 2), sy = nz + 2;
  float* fld = field_ptr(O, f);
  const int l1 = sd == 0 ? 1 : nz;
  const int l2 = sd == 0 ? 2 : nz - 1;
  const int lg = sd == 0 ? 0 : nz + 1;
  const BCEntry3 b = P.bc[f][2][sd];
  const long lane = r * sx + s * sy;
  const float un = O.f[4][clampi(r, 1, nx) * sx + clampi(s, 1, ny) * sy + l1];
  fld[lane + lg] = bc_ghost(b, fld[lane + l1], fld[lane + l2], P.d[2],
                            b.value, un, sd);
}

dim3 cell_grid(const QGD3DParams& P, int extra) {
  return dim3((P.nz + extra + BX - 1) / BX, (P.ny + extra + BY - 1) / BY,
              P.nx + extra);
}

}  // namespace

extern "C" {

int qgd3d_dt_partials(const QGD3DParams* prm) {
  const dim3 g = cell_grid(*prm, 1);
  return static_cast<int>(g.x * g.y * g.z);
}

int qgd3d_dt(const QGD3DParams* prm, const float* T, const float* ux,
             const float* uy, const float* uz, const float* dt_old,
             float* partials, float* dt_new, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = cell_grid(*prm, 1);
  qgd3d_dt_partial_kernel<<<grid, dim3(BX, BY), 0, st>>>(*prm, T, ux, uy, uz,
                                                         partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n = (long)grid.x * grid.y * grid.z;
  qgd3d_dt_final_kernel<<<1, RED, 0, st>>>(*prm, partials, n, DT_FULL, dt_old,
                                           dt_new);
  return static_cast<int>(cudaGetLastError());
}

// This slab's dt partials folded to the quad (max wave x, y, z, -min tau):
// what a MAX all-reduce over the ranks combines.
int qgd3d_dt_fold(const QGD3DParams* prm, const float* T, const float* ux,
                  const float* uy, const float* uz, float* partials,
                  float* quad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = cell_grid(*prm, 1);
  qgd3d_dt_partial_kernel<<<grid, dim3(BX, BY), 0, st>>>(*prm, T, ux, uy, uz,
                                                         partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n = (long)grid.x * grid.y * grid.z;
  qgd3d_dt_final_kernel<<<1, RED, 0, st>>>(*prm, partials, n, DT_FOLD,
                                           nullptr, quad);
  return static_cast<int>(cudaGetLastError());
}

// setDeltaT on a reduced quad of qgd3d_dt_fold.
int qgd3d_dt_apply(const QGD3DParams* prm, const float* quad,
                   const float* dt_old, float* dt_new, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qgd3d_dt_final_kernel<<<1, RED, 0, st>>>(*prm, quad, 1, DT_APPLY, dt_old,
                                           dt_new);
  return static_cast<int>(cudaGetLastError());
}

int qgd3d_update(const QGD3DParams* prm, const float* p, const float* T,
                 const float* ux, const float* uy, const float* uz,
                 const float* sc, const float* dt, float* pn, float* Tn,
                 float* uxn, float* uyn, float* uzn, float* side,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Frames F;
  F.p = p;
  F.T = T;
  F.u[0] = ux;
  F.u[1] = uy;
  F.u[2] = uz;
  qgd3d_update_kernel<<<cell_grid(*prm, 0), dim3(BX, BY), 0, st>>>(
      *prm, F, sc, dt, pn, Tn, uxn, uyn, uzn, side);
  return static_cast<int>(cudaGetLastError());
}

int qgd3d_sensor(const QGD3DParams* prm, const float* p, const float* T,
                 const float* sc, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qgd3d_sensor_kernel<<<cell_grid(*prm, 0), dim3(BX, BY), 0, st>>>(*prm, p, T,
                                                                   sc, out);
  return static_cast<int>(cudaGetLastError());
}

int qgd3d_ghosts(const QGD3DParams* prm, const float* planes,
                 const float* side, float* p, float* T, float* ux, float* uy,
                 float* uz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OutFrames O;
  O.f[0] = p;
  O.f[1] = T;
  O.f[2] = ux;
  O.f[3] = uy;
  O.f[4] = uz;
  const long nx = prm->nx, ny = prm->ny, nz = prm->nz;
  const dim3 gx((unsigned)((ny * nz + GT - 1) / GT), 10);
  qgd3d_ghost_x_kernel<<<gx, GT, 0, st>>>(*prm, planes, side, O);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gy((unsigned)(((nx + 2) * nz + GT - 1) / GT), 10);
  qgd3d_ghost_y_kernel<<<gy, GT, 0, st>>>(*prm, O);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gz((unsigned)(((nx + 2) * (ny + 2) + GT - 1) / GT), 10);
  qgd3d_ghost_z_kernel<<<gz, GT, 0, st>>>(*prm, O);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
