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
//   qgd3d_update  the face fluxes (jm, Pi, q with the `full` tangential
//                 differences), each face once, and the explicit update of
//                 every interior cell into NEW frames p, T, ux, uy, uz, plus
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
// warp reads 32 neighbouring z cells of one (x, y) line.
//
// qgd3d_update replaces the stencil body of the TPU kernel
// (fused_qgd3d.py:400-521), which computes the thermo and coefficient fields
// once per cell over a window resident in VMEM and builds each axis's faces
// once.  On this card the update moves at least 5 frames in and 5 out (+ the
// sensor frame for varScModel5), ~40-44 B per cell, but each cell also needs
// ~3 faces of ~250 float operations over ten cells each: what bounds it is
// issuing those operations and their operand loads, and keeping enough warps
// resident to hide the waits.  Its design:
//   - a block owns a TY x TZ tile of (y, z) cells and marches along x over a
//     chunk of CX planes (many chunks per column, so the card gets several
//     waves of blocks);
//   - a ring of NSLOT plane slots in shared memory holds planes x-1, x, x+1,
//     each with its y and z halo, and the plane in flight, which cp.async
//     brings in while plane x is computed (4-byte copies: any nz);
//   - when a plane lands, each staged cell's rho and coefficients are
//     computed once, with the zero-gradient coefficient ghosts;
//   - each face is computed once: a thread keeps the x-face x+1/2 of its cell
//     in registers as the next plane's low face, and the tile's y- and
//     z-faces of plane x go to shared memory;
//   - the march starts one plane before the chunk, and that pass computes
//     only the first x-face, so every face comes from one code site and its
//     bits do not depend on where a chunk or a slab starts: K5's update on a
//     slab is the serial update's window bit for bit.
// TY = 8, TZ = 32, CX = 16: 256 threads and 65,440 bytes of dynamic shared
// memory per block, and registers capped so that three blocks (24 warps) fit
// on an SM.  Each face is a long chain of shared loads and float
// operations; the time follows that chain's latency more than the tile, the
// chunk or the blocks per SM.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "smooth_ring.cuh"

namespace {

enum { BC_ZG = 0, BC_FIXED = 1, BC_GRAD = 2, BC_SYM = 3, BC_EXTRAP = 4,
       BC_IO = 5, BC_QGDFLUX = 6 };

constexpr int BX = 32;   // threads along z
constexpr int BY = 8;    // threads along y
constexpr int RED = 256; // threads of the final dt reduction
constexpr int GT = 128;  // threads of a ghost launch

// qgd3d_update's tile, chunk and plane ring
constexpr int TZ = 32;               // tile cells along z: one warp per row
constexpr int TY = 8;                // tile rows along y
constexpr int CX = 16;               // planes one block marches along x
constexpr int NT = TZ * TY;          // threads of an update block
constexpr int WZ = TZ + 2;           // a staged row: its lanes and two halo
constexpr int TILE = (TY + 2) * WZ;  // staged cells of one plane
constexpr int NSLOT = 4;             // planes x-1, x, x+1 and the one in flight
// the fields of a ring slot: the frames' values, then what derive computes
enum { S_P, S_T, S_UX, S_UY, S_UZ, S_SC, S_RHO, S_MU, S_AU, S_TC, S_NF };
constexpr int SLOT = S_NF * TILE;
constexpr int YF = (TY + 1) * TZ;    // the y-faces of one plane's tile
constexpr int ZF = TY * (TZ + 1);    // its z-faces
constexpr int UPDATE_SMEM =
    static_cast<int>(sizeof(float)) * (NSLOT * SLOT + 5 * (YF + ZF));

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
  // qgd3d_smooth: maxRatio (smooth_ring.cuh)
  float smooth_ratio;
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

// Frame f of p, T, ux, uy, uz.
__device__ __forceinline__ const float* frame_of(const Frames& F, int f) {
  return f == 0 ? F.p : (f == 1 ? F.T : F.u[f - 2]);
}

// The step between neighbouring staged cells along an axis of a ring slot:
// 0 along x, whose neighbours lie in the next or previous slot.
__host__ __device__ constexpr int tile_step(int ax) {
  return ax == 1 ? WZ : (ax == 2 ? 1 : 0);
}

// Staged cell i of ring slot S: the frame values and the derived rho.
__device__ __forceinline__ Cell tile_cell(const QGD3DParams& P,
                                          const float* S, int i) {
  Cell c;
  c.p = S[S_P * TILE + i];
  c.T = S[S_T * TILE + i];
  c.rho = S[S_RHO * TILE + i];
  c.e = P.Cv * c.T;
#pragma unroll
  for (int j = 0; j < 3; ++j) c.u[j] = S[(S_UX + j) * TILE + i];
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

// The face between staged cell A (index ia of ring slot S0) and B = A +
// e_AX: B lies in Sp, the next plane's slot, for AX = 0 and in S0
// otherwise.  Sm and Sp are the slots of the planes before and after S0,
// which the x-differences of y- and z-faces read.  The rho, coefficient and
// frame values all come from the ring.  Mirrors the per-axis body of the
// reference kernel (fused_qgd3d.py:446-521).
template <int AX>
__device__ __forceinline__ Flux face_flux(const QGD3DParams& P,
                                          const float* Sm, const float* S0,
                                          const float* Sp, int ia) {
  constexpr int B1 = AX == 0 ? 1 : 0;
  constexpr int B2 = AX == 2 ? 1 : 2;
  const float* SB = AX == 0 ? Sp : S0;
  const int ib = ia + tile_step(AX);
  const Cell A = tile_cell(P, S0, ia);
  const Cell B = tile_cell(P, SB, ib);

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
  const float muf = xi(S0[S_MU * TILE + ia], SB[S_MU * TILE + ib]);
  const float af = P.mu_const0
                       ? muf * P.inv_Pr_tau
                       : xi(S0[S_AU * TILE + ia], SB[S_AU * TILE + ib]);
  const float tcf = xi(S0[S_TC * TILE + ia], SB[S_TC * TILE + ib]);
  const float tauf = P.varsc ? (P.alpha / tcf) * P.d[AX] : tcf * P.d[AX];

  // gradients at the face: gU[i][j] = dU_j/dx_i
  float gU[3][3], gR[3], gP[3], ge[3];
  const float ia_d = P.inv_d[AX];
#pragma unroll
  for (int j = 0; j < 3; ++j) gU[AX][j] = (B.u[j] - A.u[j]) * ia_d;
  gR[AX] = (B.rho - A.rho) * ia_d;
  gP[AX] = (B.p - A.p) * ia_d;
  ge[AX] = (B.e - A.e) * ia_d;
  // tangential: central difference of the face values along each other axis
  // (along x the neighbours lie in the slots Sp and Sm)
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int b = n == 0 ? B1 : B2;
    const int o = tile_step(b);
    const Cell Ap = tile_cell(P, b == 0 ? Sp : S0, ia + o);
    const Cell Bp = tile_cell(P, b == 0 ? Sp : SB, ib + o);
    const Cell Am = tile_cell(P, b == 0 ? Sm : S0, ia - o);
    const Cell Bm = tile_cell(P, b == 0 ? Sm : SB, ib - o);
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

__device__ __forceinline__ void store_face(float* buf, int n, int w,
                                           const Flux& fl) {
#pragma unroll
  for (int k = 0; k < 5; ++k) buf[k * n + w] = fl.f[k];
}

// The x-march (see the note at the top).  Block (bx, by, bz) owns the cells
// t0 = 1 + TZ*bx .. +TZ-1, s0 = 1 + TY*by .. +TY-1 of the planes r0 = 1 +
// CX*bz .. re; thread (tz, ty) owns the cell (s0 + ty, t0 + tz) of each.
// Staged cell i of a slot is the frame cell (s0 - 1 + i / WZ, t0 - 1 + i %
// WZ) of its plane; staged rows and lanes beyond the frame repeat its last
// one, so every staged value is finite, and no live cell reads them.
__global__ void __launch_bounds__(NT, 3)
qgd3d_update_kernel(QGD3DParams P, Frames F, const float* __restrict__ sc,
                    const float* __restrict__ dt, float* __restrict__ pn,
                    float* __restrict__ Tn, float* __restrict__ uxn,
                    float* __restrict__ uyn, float* __restrict__ uzn,
                    float* __restrict__ side) {
  extern __shared__ float smem[];   // the ring, then the y- and z-faces
  float* const yfl = smem + NSLOT * SLOT;  // [5][TY + 1][TZ]
  float* const zfl = yfl + 5 * YF;         // [5][TY][TZ + 1]
  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * TZ + tz;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * sy;
  const int s0 = 1 + blockIdx.y * TY, t0 = 1 + blockIdx.x * TZ;
  const int r0 = 1 + blockIdx.z * CX;
  const int re = r0 + CX - 1 < nx ? r0 + CX - 1 : nx;

  auto slot = [&](int q) { return smem + (q & (NSLOT - 1)) * SLOT; };
  auto staged = [&](int i, int& s, int& t) {
    s = s0 - 1 + i / WZ;
    t = t0 - 1 + i % WZ;
    if (s > ny + 1) s = ny + 1;
    if (t > nz + 1) t = nz + 1;
  };
  // plane q's frame values into its slot, by cp.async; this thread copies
  // the staged cells tid, tid + NT, ...
  auto stage = [&](int q) {
    float* S = slot(q);
    for (int i = tid; i < TILE; i += NT) {
      int s, t;
      staged(i, s, t);
      const long g = q * sx + s * sy + t;
#pragma unroll
      for (int f = 0; f < 5; ++f)
        __pipeline_memcpy_async(S + f * TILE + i, frame_of(F, f) + g,
                                sizeof(float));
      if (P.varsc)
        __pipeline_memcpy_async(S + S_SC * TILE + i, sc + g, sizeof(float));
    }
  };
  // rho and the coefficient fields of plane q's staged cells: the cells this
  // thread staged, so its own wait for the copies suffices.  The
  // coefficients take zero-gradient ghosts at physical boundaries: a y-ghost
  // row, a z-ghost lane and an x-ghost plane take the value of the interior
  // cell beside them (read from the frame); a halo plane across a partition
  // keeps its own.
  auto derive = [&](int q) {
    float* S = slot(q);
    const int rc =
        q == 0 && P.edge_lo ? 1 : (q == nx + 1 && P.edge_hi ? nx : q);
    for (int i = tid; i < TILE; i += NT) {
      int s, t;
      staged(i, s, t);
      const float p = S[S_P * TILE + i], T = S[S_T * TILE + i];
      S[S_RHO * TILE + i] = p / (P.R * T);
      const int cs = clampi(s, 1, ny), ct = clampi(t, 1, nz);
      float cp = p, cT = T, csc = P.varsc ? S[S_SC * TILE + i] : 0.0f;
      if (rc != q || cs != s || ct != t) {
        const long g = rc * sx + cs * sy + ct;
        cp = F.p[g];
        cT = F.T[g];
        csc = P.varsc ? sc[g] : 0.0f;
      }
      const Coef k = cell_coef(P, cp, cT, csc);
      S[S_MU * TILE + i] = k.mu;
      S[S_AU * TILE + i] = k.au;
      S[S_TC * TILE + i] = k.tc;
    }
  };

  const int ic = (ty + 1) * WZ + tz + 1;  // this thread's cell in a slot
  const int s = s0 + ty, t = t0 + tz;
  const bool live = s <= ny && t <= nz;
  const long j = (long)(s - 1) * nz + (t - 1);
  const float sdt = dt[0] * P.inv_vol;
  float xlo[5];

  stage(r0 - 1);
  __pipeline_commit();
  stage(r0);
  __pipeline_commit();
  // pass r computes the x-face r+1/2 and, from r0 on, updates plane r; the
  // pass r0 - 1 only gives the chunk's first x-face
#pragma unroll 1
  for (int r = r0 - 1; r <= re; ++r) {
    // plane r+2 goes to the slot of plane r-2, which no thread reads since
    // the last barrier
    if (r + 2 <= re + 1) stage(r + 2);
    __pipeline_commit();          // a group per pass, empty at the end
    __pipeline_wait_prior(1);     // this thread's copies of plane r+1
#pragma unroll 1
    for (int q = r == r0 - 1 ? r : r + 1; q <= r + 1; ++q) derive(q);
    __syncthreads();  // plane r+1 complete; the last pass's faces read
    const float* Sm = slot(r - 1);
    const float* S0 = slot(r);
    const float* Sp = slot(r + 1);
    const Flux hi = face_flux<0>(P, Sm, S0, Sp, ic);
    // ws/tau_f on the physical x-boundary faces: the qgdFlux p ghost of this
    // step
    if (live && ((r == 0 && P.edge_lo) || (r == nx && P.edge_hi)))
      side[(r == 0 ? 0 : (long)ny * nz) + j] = hi.ws / hi.tau;
    if (r >= r0) {
      // the tile's y-faces (row w / TZ of YF: between staged rows w / TZ and
      // w / TZ + 1) and z-faces of plane r, each once
#pragma unroll 1
      for (int w = tid; w < YF + ZF; w += NT) {
        if (w < YF) {
          store_face(yfl, YF, w, face_flux<1>(P, Sm, S0, Sp,
                                              (w / TZ) * WZ + w % TZ + 1));
        } else {
          const int v = w - YF;
          store_face(zfl, ZF, v,
                     face_flux<2>(P, Sm, S0, Sp,
                                  (v / (TZ + 1) + 1) * WZ + v % (TZ + 1)));
        }
      }
    }
    __syncthreads();  // the faces of plane r
    if (r >= r0 && live) {
      float acc[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float* yk = yfl + k * YF + ty * TZ + tz;
        const float* zk = zfl + k * ZF + ty * (TZ + 1) + tz;
        acc[k] = hi.f[k] - xlo[k];
        acc[k] = acc[k] + (yk[TZ] - yk[0]);
        acc[k] = acc[k] + (zk[1] - zk[0]);
      }
      const Cell o = tile_cell(P, S0, ic);
      const float rho = o.rho;
      const float ke = o.u[0] * o.u[0] + o.u[1] * o.u[1] + o.u[2] * o.u[2];
      const float rhoE = rho * (o.e + 0.5f * ke);
      const float rhon = rho - sdt * acc[0];
      const float inv_rhon = 1.0f / rhon;
      float un[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        un[k] = (rho * o.u[k] - sdt * acc[1 + k]) * inv_rhon;
      const float rhoEn = rhoE - sdt * acc[4];
      const float en = rhoEn * inv_rhon -
                       0.5f * (un[0] * un[0] + un[1] * un[1] + un[2] * un[2]);
      const float Tv = en * P.inv_Cv;
      const long i0 = r * sx + s * sy + t;
      pn[i0] = rhon * P.R * Tv;
      Tn[i0] = Tv;
      uxn[i0] = un[0];
      uyn[i0] = un[1];
      uzn[i0] = un[2];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) xlo[k] = hi.f[k];
  }
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

// The update's dynamic shared memory is above the 48 KB a launch gets
// without asking: allow it once on each device.
cudaError_t allow_update_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(qgd3d_update_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           UPDATE_SMEM);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}


// ---------------------------------------------------------------------------
// qgd3d_smooth: fvc::smooth of the raw sensor, k rings per launch
// ---------------------------------------------------------------------------
//
// Replaces the XLA fvc_smooth the reference runs between K4's calls
// (qgdsolver_tpu/ops/fused_qgd3d.py:841-844): rings of
// f <- max(f, nbr_max(f)/maxRatio) over the six face neighbours (a cell
// beyond a physical edge is the cell itself) to the fixed point.  A launch
// runs k rings of the (nx, ny, nz) cells it reads into the sensor frame,
// ghosts edge-replicated, and sets the flag when the last ring raised a
// written cell; the host launches again while it is set.  As in
// qgd2d_smooth, ring j is valid on the block's region shrunk by j cells, the
// ring is smooth_ring.cuh's, and the result is the plain loop's bit for bit
// whatever k.
//
// The halo costs more in 3D (a cube with a k-cell halo stages
// (T / (T - 2k))^3 of what it writes), so a block owns a (y, z) tile with a
// k-cell halo in y and z and marches along x over a chunk of planes (and k
// planes before and after it), keeping the k levels of the ring pipeline in
// registers: when raw plane s arrives, level j (ring j) computes plane s - j
// from level j - 1's planes s - j - 1, s - j, s - j + 1.  Each level keeps
// its last three planes of the thread's cells in registers, for the x
// neighbours; the in-plane neighbours come from shared memory, where every
// level publishes its newest plane, in two buffers used in turn (by plane
// parity), so one barrier per plane serves all k levels.  A thread owns
// S3R rows of one z-lane: its y neighbours but the first and last are its
// own registers.  Cells beyond a physical edge hold -FLT_MAX and keep it,
// as in qgd2d_smooth.  A step is short next to a load from memory, and a
// block's 16 warps are all an SM holds, so each thread copies its raw
// cells S3D planes ahead (cp.async) into a ring of shared planes that only
// it reads.

constexpr int S3Z = 64;                     // tile lanes (z), one per thread
constexpr int S3T = 8;                      // thread rows
constexpr int S3R = 4;                      // tile rows a thread owns
constexpr int S3Y = S3T * S3R;              // tile rows (y)
constexpr int S3W = S3Z + 2;                // a published row, with pads
constexpr int S3P = (S3Y + 2) * S3W;        // a published plane
constexpr int S3D = 4;                      // raw planes in flight
constexpr int SMOOTH3_KMAX = 4;             // rings a launch may run

// the published planes of the K levels, then the ring of raw planes
template <int K>
constexpr int smooth3_smem() {
  return static_cast<int>(sizeof(float)) *
         (2 * S3P * (K > 0 ? K : 1) + S3D * S3Y * S3Z);
}

struct Smooth3 {
  const float* __restrict__ in;  // cell (0, 0, 0)
  long sx, sy;                   // its x and y strides (z: 1)
  float* __restrict__ out;       // the (nx+2, ny+2, nz+2) frame
  float* __restrict__ chg;
  int cx;                        // planes a block writes
};

// v into the frame at cell (x, y, z), and into the ghosts beside it: along
// z, then the rows of those along y, then the planes of those along x (a
// ghost of an edge or a corner too).  Straight-line predicated stores: a
// warp whose lanes include one boundary cell pays a few instructions, not a
// loop over the 26 directions.
__device__ __forceinline__ void smooth3_put(const QGD3DParams& P, float* out,
                                            int x, int y, int z, float v) {
  const long wy = P.nz + 2, wx = (long)(P.ny + 2) * wy;
  const bool zl = z == 0, zh = z == P.nz - 1;
  const bool yl = y == 0, yh = y == P.ny - 1;
  const bool xl = x == 0, xh = x == P.nx - 1;
  const auto row = [&](float* q) {
    *q = v;
    if (zl) q[-1] = v;
    if (zh) q[1] = v;
  };
  const auto plane = [&](float* q) {
    row(q);
    if (yl) row(q - wy);
    if (yh) row(q + wy);
  };
  float* o = out + (x + 1) * wx + (y + 1) * wy + z + 1;
  plane(o);
  if (xl) plane(o - wx);
  if (xh) plane(o + wx);
}

// This thread's cells of raw plane s in the ring of raw planes (slot s mod
// S3D).
__device__ __forceinline__ float* smooth3_raw(float* ring, int s) {
  return ring + (s & (S3D - 1)) * S3Y * S3Z + threadIdx.y * S3R * S3Z +
         threadIdx.x;
}

// Copies this thread's cells of raw plane s into the ring as one cp.async
// group (-FLT_MAX beyond the mesh).
template <bool EDGE>
__device__ __forceinline__ void smooth3_fetch(const QGD3DParams& P,
                                              const Smooth3& A, float* ring,
                                              int s, int y0, int z0,
                                              const bool (&yin)[S3R],
                                              bool zin) {
  const int tz = threadIdx.x, a0 = threadIdx.y * S3R;
  const bool xin = s >= 0 && s < P.nx;
  float* dst = smooth3_raw(ring, s);
#pragma unroll
  for (int i = 0; i < S3R; ++i) {
    if (xin && (!EDGE || (yin[i] && zin)))
      __pipeline_memcpy_async(
          dst + i * S3Z, A.in + s * A.sx + (y0 + a0 + i) * A.sy + z0 + tz,
          sizeof(float));
    else
      dst[i * S3Z] = -FLT_MAX;
  }
  __pipeline_commit();
}

// One step of the march with raw plane s arriving (fetched S3D - 1 steps
// ahead; plane s + S3D - 1 is fetched now); U = (s - first step) mod 3
// names the register slots: plane q of any level sits in slot
// (q - first step) mod 3.
template <int K, bool EDGE, int U>
__device__ __forceinline__ void smooth3_step(
    const QGD3DParams& P, const Smooth3& A, float (&pl)[K][3][S3R],
    float* __restrict__ ring, float* __restrict__ sp, int s, int x0, int y0,
    int z0, const bool (&yin)[S3R], bool zin, float inv, bool& raised) {
  const int tz = threadIdx.x, a0 = threadIdx.y * S3R;
  const int nx = P.nx;
  smooth3_fetch<EDGE>(P, A, ring, s + S3D - 1, y0, z0, yin, zin);
  __pipeline_wait_prior(S3D - 1);  // this thread's copies of plane s
  const float* raw = smooth3_raw(ring, s);
#pragma unroll
  for (int i = 0; i < S3R; ++i) pl[0][U][i] = raw[i * S3Z];
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    const int p = s - j;
    const bool pin = p >= 0 && p < nx;
    constexpr int B = 3 * (K + 2);  // keeps the slot arithmetic positive
    const int lo = (U - j - 1 + B) % 3, mid = (U - j + B) % 3,
              hi = (U - j + 1 + B) % 3;
    const float(&f)[3][S3R] = pl[j - 1];
    const float* q = sp + ((j - 1) * 2 + (p & 1)) * S3P + (a0 + 1) * S3W + tz +
                     1;
    const bool write = j == K && pin && p >= x0 && p < x0 + A.cx &&
                       tz >= K && tz < S3Z - K;
#pragma unroll
    for (int i = 0; i < S3R; ++i) {
      const float c = f[mid][i];
      const float yl = i > 0 ? f[mid][i - 1] : q[(i - 1) * S3W];
      const float yh = i + 1 < S3R ? f[mid][i + 1] : q[(i + 1) * S3W];
      float nb = fmaxf(fmaxf(c, f[lo][i]), f[hi][i]);
      nb = fmaxf(nb, fmaxf(fmaxf(yl, yh),
                           fmaxf(q[i * S3W - 1], q[i * S3W + 1])));
      float v = smooth_ring<true>(c, nb, P.smooth_ratio, inv);
      const bool in = pin && (!EDGE || (yin[i] && zin));
      if (!in) v = -FLT_MAX;
      if (j < K) {
        pl[j][mid][i] = v;
      } else if (write && in && a0 + i >= K && a0 + i < S3Y - K) {
        smooth3_put(P, A.out, p, y0 + a0 + i, z0 + tz, v);
        if (v > c) raised = true;
      }
    }
  }
  // publish each level's newest plane (level l's plane s - l), then wait
#pragma unroll
  for (int l = 0; l < K; ++l) {
    float* q = sp + (l * 2 + ((s - l) & 1)) * S3P + (a0 + 1) * S3W + tz + 1;
#pragma unroll
    for (int i = 0; i < S3R; ++i) q[i * S3W] = pl[l][(U - l + 3 * K) % 3][i];
  }
  __syncthreads();
}

template <int K, bool EDGE>
__device__ __forceinline__ bool smooth3_march(const QGD3DParams& P,
                                              const Smooth3& A, float* sp,
                                              int x0, int y0, int z0,
                                              const bool (&yin)[S3R],
                                              bool zin) {
  float pl[K][3][S3R];
#pragma unroll
  for (int l = 0; l < K; ++l)
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int i = 0; i < S3R; ++i) pl[l][u][i] = -FLT_MAX;
  bool raised = false;
  const int first = x0 - K, steps = A.cx + 2 * K;
  const float inv = smooth_inverse(P.smooth_ratio);
  float* ring = sp + 2 * S3P * K;
  for (int d = 0; d < S3D - 1; ++d)
    smooth3_fetch<EDGE>(P, A, ring, first + d, y0, z0, yin, zin);
  for (int n = 0; n < steps; n += 3) {
    smooth3_step<K, EDGE, 0>(P, A, pl, ring, sp, first + n, x0, y0, z0, yin,
                             zin, inv, raised);
    if (n + 1 < steps)
      smooth3_step<K, EDGE, 1>(P, A, pl, ring, sp, first + n + 1, x0, y0, z0,
                               yin, zin, inv, raised);
    if (n + 2 < steps)
      smooth3_step<K, EDGE, 2>(P, A, pl, ring, sp, first + n + 2, x0, y0, z0,
                               yin, zin, inv, raised);
  }
  __pipeline_wait_prior(0);  // the fetches past the chunk
  return raised;
}

template <int K>
__global__ void __launch_bounds__(S3Z * S3T)
qgd3d_smooth_kernel(QGD3DParams P, Smooth3 A) {
  extern __shared__ float sp[];
  const int x0 = blockIdx.z * A.cx;
  const int y0 = blockIdx.y * (S3Y - 2 * K) - K;
  const int z0 = blockIdx.x * (S3Z - 2 * K) - K;
  const int tz = threadIdx.x, a0 = threadIdx.y * S3R;
  bool yin[S3R];
#pragma unroll
  for (int i = 0; i < S3R; ++i)
    yin[i] = y0 + a0 + i >= 0 && y0 + a0 + i < P.ny;
  const bool zin = z0 + tz >= 0 && z0 + tz < P.nz;
  if constexpr (K == 0) {
    // no ring: the cells framed
    for (int x = x0; x < x0 + A.cx && x < P.nx; ++x)
#pragma unroll
      for (int i = 0; i < S3R; ++i)
        if (yin[i] && zin)
          smooth3_put(P, A.out, x, y0 + a0 + i, z0 + tz,
                      A.in[x * A.sx + (y0 + a0 + i) * A.sy + z0 + tz]);
  } else {
    const bool edge =
        y0 < 0 || z0 < 0 || y0 + S3Y > P.ny || z0 + S3Z > P.nz;
    const bool raised =
        edge ? smooth3_march<K, true>(P, A, sp, x0, y0, z0, yin, zin)
             : smooth3_march<K, false>(P, A, sp, x0, y0, z0, yin, zin);
    if (__syncthreads_or(raised) && tz == 0 && threadIdx.y == 0)
      A.chg[0] = 1.0f;
  }
}

// The launch of K rings: its chunk of planes, which a block marches with K
// planes before and after it, chosen for the fewest planes marched by the
// busiest SM (waves of resident blocks times planes a block marches), and
// its grid.
template <int K>
cudaError_t smooth3_launch(const QGD3DParams& P, Smooth3 A, cudaStream_t st,
                           int* shape) {
  static int sms[64] = {}, bps[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = smooth3_smem<K>();
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(qgd3d_smooth_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps[dev], qgd3d_smooth_kernel<K>, S3Z * S3T, smem);
    if (e != cudaSuccess) {
      sms[dev] = 0;
      return e;
    }
  }
  const long tiles = (long)((P.nz + S3Z - 2 * K - 1) / (S3Z - 2 * K)) *
                     ((P.ny + S3Y - 2 * K - 1) / (S3Y - 2 * K));
  const long slots = (long)sms[dev] * (bps[dev] > 0 ? bps[dev] : 1);
  int cx = P.nx;
  long best = -1;
  for (int chunks = 1; chunks <= P.nx; ++chunks) {
    const int c = (P.nx + chunks - 1) / chunks;
    if ((P.nx + c - 1) / c != chunks) continue;  // the same c as fewer
    const long cost = (tiles * chunks + slots - 1) / slots * (c + 2 * K);
    if (best < 0 || cost < best) {
      best = cost;
      cx = c;
    }
  }
  A.cx = cx;
  const dim3 grid((P.nz + S3Z - 2 * K - 1) / (S3Z - 2 * K),
                  (P.ny + S3Y - 2 * K - 1) / (S3Y - 2 * K),
                  (P.nx + cx - 1) / cx);
  if (shape) {
    shape[0] = S3Y;
    shape[1] = S3Z;
    shape[2] = cx;
    shape[3] = smem;
    shape[4] = bps[dev];
    return cudaSuccess;
  }
  qgd3d_smooth_kernel<K><<<grid, dim3(S3Z, S3T), smem, st>>>(P, A);
  return cudaGetLastError();
}

cudaError_t smooth3_dispatch(int k, const QGD3DParams& P, const Smooth3& A,
                             cudaStream_t st, int* shape) {
  switch (k) {
    case 0: return smooth3_launch<0>(P, A, st, shape);
    case 1: return smooth3_launch<1>(P, A, st, shape);
    case 2: return smooth3_launch<2>(P, A, st, shape);
    case 3: return smooth3_launch<3>(P, A, st, shape);
    case 4: return smooth3_launch<4>(P, A, st, shape);
    default: return cudaErrorInvalidValue;
  }
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
  const cudaError_t e = allow_update_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((prm->nz + TZ - 1) / TZ, (prm->ny + TY - 1) / TY,
                  (prm->nx + CX - 1) / CX);
  qgd3d_update_kernel<<<grid, dim3(TZ, TY), UPDATE_SMEM, st>>>(
      *prm, F, sc, dt, pn, Tn, uxn, uyn, uzn, side);
  return static_cast<int>(cudaGetLastError());
}

// The update's launch shape on the current device: out = {TY, TZ, CX,
// dynamic shared bytes per block, resident blocks per SM}.
int qgd3d_update_shape(int* out) {
  cudaError_t e = allow_update_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, qgd3d_update_kernel, NT, UPDATE_SMEM);
  out[0] = TY;
  out[1] = TZ;
  out[2] = CX;
  out[3] = UPDATE_SMEM;
  out[4] = blocks;
  return static_cast<int>(e);
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

// k fvc::smooth rings (0 <= k <= SMOOTH3_KMAX) of the (nx, ny, nz) cells at
// in (cell (x, y, z) at in[x * sx + y * sy + z]) into the frame out, ghosts
// edge-replicated; chg <- 1 if the last ring raised a cell, else 0.
int qgd3d_smooth(const QGD3DParams* prm, const float* in, long sx, long sy,
                 int k, float* out, float* chg, void* stream) {
  if (k < 0 || k > SMOOTH3_KMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(chg, 0, sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Smooth3 A;
  A.in = in;
  A.sx = sx;
  A.sy = sy;
  A.out = out;
  A.chg = chg;
  A.cx = 0;
  return static_cast<int>(smooth3_dispatch(k, *prm, A, st, nullptr));
}

// qgd3d_smooth's launch of k rings at prm's shape on the current device:
// out = {tile rows (y), tile lanes (z), chunk planes, dynamic shared bytes
// per block, resident blocks per SM}.
int qgd3d_smooth_shape(const QGD3DParams* prm, int k, int* out) {
  Smooth3 A = {};
  return static_cast<int>(smooth3_dispatch(k, *prm, A, nullptr, out));
}

}  // extern "C"
