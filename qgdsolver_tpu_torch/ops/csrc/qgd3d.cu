// Hand-written Hopper (sm_90a) kernels for one explicit 3D QGDFoam step.
//
// Replaces the TPU kernel qgdsolver_tpu/ops/fused_qgd3d.py::
// build_fused_step_3d (the x-slab Pallas kernel at :349) together with its
// XLA dt pre-pass (`_dt_prepass`, :664).  The TPU kernel walks x-slabs in
// order on one core with a frame-wide dt taken before it; blocks on a GPU run
// in no order and cannot wait for each other, so the step is four launches
// on the caller's stream, with dt kept on the device:
//
//   qgd3d_dt      an x-march over (y, z) tiles: per-block max wave speed per
//                 axis and tau coefficient extremes, folded by the last
//                 block to finish, which applies setDeltaT (one launch);
//   qgd3d_update  the face fluxes (jm, Pi, q with the `full` tangential
//                 differences), each face once, and the explicit update of
//                 every interior cell into NEW frames p, T, ux, uy, uz, plus
//                 ws/tau_f on the two x-boundary faces (the qgdFlux ghost);
//   qgd3d_emit    varScModel5 only: the raw sensor over the fresh frames,
//                 its first fvc::smooth ring as the next sensor frame and
//                 the ring's change flag (one launch of its own, because it
//                 reads fresh rho at cells that other blocks of the update
//                 write); qgd3d_sensor is its mode that writes the raw
//                 sensor alone;
//   qgd3d_ghosts  every ghost of the fresh frames, x planes, y rows over
//                 every x and z lanes over every x and y, each computed from
//                 interior cells (one launch);
//
// and, only when the flag is set, qgd3d_smooth carries ring 1 to the fixed
// point: in three line sweeps (its fixed point, below), or where they do
// not hold k rings a launch.
//
// The x-ring decomposition K5 (build_sharded_fused_step_3d, :930) runs the
// same kernels on each rank's x-slab, whose x ends may be partition planes:
// there the halo plane holds the neighbour's true cells, and the flags
// edge_lo / edge_hi of QGD3DParams (1: a physical boundary) make the
// kernels read it as it is: no zero-gradient coefficient ghost, no tau
// clamp in qgd3d_dt, no qgdFlux side plane, no x-ghost plane (the plane
// exchange fills it), and the sensor's x-gradient reads the exchanged
// plane (qgd3d_sensor runs after the exchange; its rings run in plain
// torch, since ring 1 crosses the partition).  The serial builders set
// both flags to 1.  dt over the ranks: qgd3d_dt_fold (qgd3d_dt's launch,
// writing the quad), a MAX all-reduce of its quad (max wave x, y, z, -min
// tau), then qgd3d_dt_apply.
//
// Frames are contiguous (nx+2, ny+2, nz+2) float32 with z the fast axis, so a
// warp reads 32 neighbouring z cells of one (x, y) line.
//
// qgd3d_update replaces the stencil body of the TPU kernel
// (fused_qgd3d.py:400-521), which computes the thermo and coefficient fields
// once per cell over a window resident in VMEM and builds each axis's faces
// once.  On this card the update moves at least 5 frames in and 5 out (+ the
// sensor frame for varScModel5), ~40-44 B per cell, but each cell also needs
// ~3 faces of ~140 float operations, each over the values of its two cells
// and the tangential gradients of its face values: what bounds it is
// issuing those instructions (~1,000 a cell and plane) and the shared-memory
// accesses that bring a face its operands, with as many warps resident as
// the registers allow to hide the waits.  So each operand is worked out once
// and a face combines what its cells and its neighbouring faces published:
//   - a cell's base values (p, rho, e = Cv*T, u, the coefficients mu,
//     alphau, the tau coefficient, and H) are worked out once per plane,
//     with the zero-gradient coefficient ghosts at physical x/y/z ends;
//   - the values of each face (u, rho, p, e) are formed once, as the sum
//     of its two cells' values, and published; a face's tangential gradient
//     is the difference of its neighbouring faces' sums times 0.5/2d, which
//     is the reference's (xi(Ap, Bp) - xi(Am, Bm)) / 2d bit for bit, since
//     halving is exact.  (The mean of the two cells' central differences is
//     equal in exact arithmetic, but rounds otherwise: it moved the duct's
//     transverse velocities by ~1e-4 of their max);
//   - a block owns a TY x TZ tile of (y, z) cells and marches along x over a
//     chunk of planes; a thread owns one (y, z) cell of the tile (a warp
//     per row) and keeps its column's base values in registers, so its
//     x-face reads only its in-plane neighbours' x-face values from shared
//     memory.  Three more warps own the ring around the tile (a row below
//     and above it, a lane before and after each row, the four corners) and
//     march their columns the same way;
//   - each pass publishes the base values of plane x+2 and the face values
//     of plane x+1 (three plane buffers used in turn, unrolled so that every
//     buffer offset is a constant) and the x-faces' values of x+1/2; a cell
//     computes its x-face x+1/2, the face below it along y and the face
//     before it along z, taking that neighbour's base values from shared
//     memory and its own from registers.  The tile's row and lane of faces
//     on the far side are the low faces of the ring's far row and lane, so
//     every face of a plane is computed once, at one code site per axis,
//     and its flux goes to shared memory once for the two cells that share
//     it; two barriers a plane;
//   - about 150 warp-wide 4-byte shared accesses a cell (against ~250 when
//     each face re-read the raw values of ten cells, and re-averaged four
//     of them for each tangential gradient);
//   - the march starts one plane before the chunk, and that pass computes
//     only the operands and the chunk's first x-face, so every face comes
//     from one code site and its bits do not depend on where a chunk or a
//     slab starts: each cell's and face's values are worked out by the same
//     code from the same frame values in whichever block holds them, and
//     K5's update on a slab is the serial update's window bit for bit.
// Threads load their own cells from the frames directly, two planes ahead
// (4-byte loads, coalesced along z: any nz); a cell beyond the frame repeats
// its last row or lane, so every value is finite, and no live cell reads it.
// TY and TZ are the constants below; the registers are capped so that one
// block fits on an SM (ptxas: no spill).  The chunk follows the grid: 32
// planes, or 16 where that gives the card more even waves (update_grid).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "nan_fold.cuh"
#include "smooth_ring.cuh"

namespace {

enum { BC_ZG = 0, BC_FIXED = 1, BC_GRAD = 2, BC_SYM = 3, BC_EXTRAP = 4,
       BC_IO = 5, BC_QGDFLUX = 6 };

constexpr int GT = 256;  // threads of a ghost block

// qgd3d_update's tile, chunk and shared buffers
constexpr int TZ = 32;               // tile lanes along z: a warp per row
constexpr int TY = 12;               // tile rows along y
constexpr int NW = TY + 3;           // warps: the tile's rows, then the ring's
constexpr int NT = 32 * NW;          // threads of an update block
// One block an SM: ptxas then gives a thread 128 registers, which the march
// fills without a spill.  Against TY = 12 on an H100 at 640x318x318 (PERF.md
// §6): TY = 8 with two blocks an SM spills, TY = 11 and 13 are 3-5% slower,
// and any operand more in registers spills.  The planes a block marches,
// the chunk, are 32 or 16 (UPDATE_CHUNKS, update_grid).
constexpr int UPDATE_MIN_BLOCKS = 1;
constexpr int UPDATE_CHUNKS[2] = {32, 16};
constexpr int WZ = TZ + 2;           // a row with its ring lanes
constexpr int EXT = (TY + 2) * WZ;   // cells of the tile and its ring
// a cell's base values; a face's values are NFV of them: u, rho, p, e
enum { B_P, B_RHO, B_E, B_UX, B_UY, B_UZ, B_MU, B_AU, B_TC, B_H, B_NF };
constexpr int NFV = 6;
constexpr int YF = (TY + 1) * TZ;    // the y-faces of one plane's tile
constexpr int ZF = TY * (TZ + 1);    // its z-faces
// three planes of base values and of the y- and z-faces' values, a plane
// of the x-faces' values, the fluxes of a plane's y- and z-faces
constexpr int UPDATE_SMEM = static_cast<int>(sizeof(float)) *
                            ((3 * B_NF + 7 * NFV) * EXT + 5 * (YF + ZF));
static_assert(2 * TY + 4 <= 32, "the ring's lanes and corners fill one warp");

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

// A cell's base values (B_P .. B_H).
struct Base {
  float v[B_NF];
};

// The base field of face value k: k = 0-2 the velocity, 3 rho, 4 p, 5 e.
__host__ __device__ constexpr int face_field(int k) {
  return k < 3 ? B_UX + k : (k == 3 ? B_RHO : (k == 4 ? B_P : B_E));
}

// The face between A and B = A + e_AX from the two cells' base values and
// the face's tangential gradients gt[n][k] of face value k along its n-th
// other axis (x before y before z): the central differences of the
// neighbouring faces' values, as the reference forms them.  Mirrors the
// per-axis body of the reference kernel (fused_qgd3d.py:446-521).
template <int AX>
__device__ __forceinline__ Flux face_flux(const QGD3DParams& P,
                                          const float* a, const float* b,
                                          const float (&gt)[2][NFV]) {
  const float pf = xi(a[B_P], b[B_P]);
  const float rf = xi(a[B_RHO], b[B_RHO]);
  float uf[3], ruf[3], urr[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uf[j] = xi(a[B_UX + j], b[B_UX + j]);
    ruf[j] = xi(a[B_RHO] * a[B_UX + j], b[B_RHO] * b[B_UX + j]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    urr[k] = xi(a[B_UX + AX] * (a[B_RHO] * a[B_UX + k]),
                b[B_UX + AX] * (b[B_RHO] * b[B_UX + k]));
  const float Hf = xi(a[B_H], b[B_H]);
  const float muf = xi(a[B_MU], b[B_MU]);
  const float af = P.mu_const0 ? muf * P.inv_Pr_tau : xi(a[B_AU], b[B_AU]);
  const float tcf = xi(a[B_TC], b[B_TC]);
  const float tauf = P.varsc ? (P.alpha / tcf) * P.d[AX] : tcf * P.d[AX];

  // gradients at the face: gU[i][j] = dU_j/dx_i
  float gU[3][3], gR[3], gP[3], ge[3];
  const float ia_d = P.inv_d[AX];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    gU[AX][j] = (b[B_UX + j] - a[B_UX + j]) * ia_d;
  gR[AX] = (b[B_RHO] - a[B_RHO]) * ia_d;
  gP[AX] = (b[B_P] - a[B_P]) * ia_d;
  ge[AX] = (b[B_E] - a[B_E]) * ia_d;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int t = n == 0 ? (AX == 0 ? 1 : 0) : (AX == 2 ? 1 : 2);
#pragma unroll
    for (int j = 0; j < 3; ++j) gU[t][j] = gt[n][j];
    gR[t] = gt[n][3];
    gP[t] = gt[n][4];
    ge[t] = gt[n][5];
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// qgd3d_dt: the acoustic Courant number and min tau_f, then setDeltaT
// ---------------------------------------------------------------------------
//
// Replaces the reference's XLA dt pre-pass (`_dt_prepass`,
// qgdsolver_tpu/ops/fused_qgd3d.py:664): over the live faces of each axis,
// the max acoustic wave |u_f| + c_f and the min tau_f with zero-gradient
// coefficient ghosts at physical boundaries, then setDeltaT.  It reads four
// frames once (T, ux, uy, uz) and does ~10 operations a cell, so bytes
// bound it.  A block owns a DY x DZ tile of frame (y, z) cells, ghost rows
// and lanes included, and marches a chunk of x-planes: each cell's T and
// velocity are loaded once, coalesced along z, the next plane's ahead of
// the current one's faces, and its c = gRT*rsqrt(gRT) and tau coefficient
// are computed once; the x-face takes the previous plane from registers,
// the z-face its neighbour by warp shuffle, the y-face its neighbour from
// shared memory, with one barrier a plane.  The halo cells (the next
// tile's first row, which warp 0 computes, and the next tile's first lane
// of each row, which DY lanes of warp 1 compute) go through shared memory
// too, so no warp runs a cell alone for one lane.  The tau
// coefficient of a face is folded per axis (max c_f for varScModel5, min
// (alpha/c)_f otherwise) and divided once per axis at the end: RN(alpha/x)
// and RN(x*d) are monotone, so the min over faces of tau_f is the same
// float.  Each block writes its partial and the last block to finish
// (a ticket in the workspace, which that block sets back to 0) folds them
// and applies setDeltaT (DT_FULL) or writes the quad (DT_FOLD), so a call
// is one launch.  The face formulas write out nvcc's contraction of the
// face expressions (c_A + c_B as fma(g_A, rsqrt(g_A), c_B)) and max and
// min are exact in any order, so the tile, the chunk and the fold order
// do not move a bit.

constexpr int DZ = 32;             // tile lanes (z): one warp a row
constexpr int DY = 8;              // tile rows (y)
constexpr int DT_NT = DZ * DY;     // threads of a dt block
constexpr int DT_NQ = 6;           // a partial: 3 max waves, 3 tau extremes
constexpr int DT_HEAD = 4;         // the workspace's ticket, padded

enum { DT_FULL = 0, DT_FOLD = 1 };

// What a face needs of its cell: the velocity along the face's axis, g =
// gammaR*T, r = rsqrt(g), c = RN(g*r) and the tau coefficient (c, or
// alpha/c under the constScPr family).
struct DtCell {
  float u, g, r, c, tc;
};

__device__ __forceinline__ DtCell dt_cell(const QGD3DParams& P, float T,
                                          float u) {
  DtCell k;
  k.u = u;
  k.g = __fmul_rn(P.gammaR, T);
  k.r = rsqrtf(k.g);
  k.c = __fmul_rn(k.g, k.r);
  k.tc = P.varsc ? k.c : __fdiv_rn(P.alpha, k.c);
  return k;
}

// |u_f| + c_f of the face between A (low) and B (high).
__device__ __forceinline__ float dt_wave(const DtCell& A, float uB,
                                         float cB) {
  return __fadd_rn(fabsf(__fmul_rn(0.5f, __fadd_rn(A.u, uB))),
                   __fmul_rn(0.5f, __fmaf_rn(A.g, A.r, cB)));
}

// the face's tau coefficient, from its two (clamped) cells
__device__ __forceinline__ float dt_coef(float ta, float tb) {
  return __fmul_rn(0.5f, __fadd_rn(ta, tb));
}

// The fold of one partial entry: waves (a < 3) and varScModel5's c_f take
// the max, the constScPr family's (alpha/c)_f the min.
__device__ __forceinline__ float dt_fold(float v, float w, int a, bool vs) {
  return a < 3 || vs ? nan_max(v, w) : nan_min(v, w);
}

// v over the block (warp shuffles, one slot a warp, one barrier); thread
// 0 holds the result.
__device__ __forceinline__ void dt_fold_block(float (&v)[DT_NQ], bool vs,
                                              float (*slots)[DT_NT / 32]) {
  const int tid = threadIdx.y * DZ + threadIdx.x;
#pragma unroll
  for (int a = 0; a < DT_NQ; ++a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[a] = dt_fold(v[a], __shfl_xor_sync(0xffffffffu, v[a], o), a, vs);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int a = 0; a < DT_NQ; ++a) slots[a][tid >> 5] = v[a];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int a = 0; a < DT_NQ; ++a)
      for (int w = 1; w < DT_NT / 32; ++w) v[a] = dt_fold(v[a], slots[a][w], a, vs);
  }
}

// setDeltaT (immediate reduction, damped increase, cTau*min(tau_f) and
// maxDeltaT caps) with explicit roundings: no FMA contraction.
__device__ __forceinline__ float set_delta_t(const QGD3DParams& P,
                                             const float (&m)[3], float tmin,
                                             float dtv) {
  if (!P.adjust_dt) return dtv;
  float co = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    co = nan_max(co, __fdiv_rn(__fmul_rn(m[a], dtv), P.d[a]));
  const float max_fact = __fdiv_rn(P.max_co, __fadd_rn(co, 1e-30f));
  const float fact = nan_min(
      nan_min(max_fact, __fadd_rn(1.0f, __fmul_rn(0.1f, max_fact))), 1.2f);
  const float max_dt1 = nan_min(P.max_dt, __fmul_rn(P.c_tau, tmin));
  return nan_min(__fmul_rn(fact, dtv), max_dt1);
}

// One plane's loads of a thread: its cell's T and velocity, and the halo
// cell it loads for its tile (warp 0: the next tile's first row, for the
// y-face; lane i < DY of warp 1: the next tile's first lane of row i, for
// the z-face).  Values a thread does not need are 1.0, and no face reads
// them.
struct DtRaw {
  float T, ux, uy, uz, Ty, uyy, Tz, uzz;
};

// Block (bx, by, bz) owns the frame cells (s, t) = (DY*by + ty, DZ*bx + tz)
// of the planes q = cx*bz .. min(cx*bz + cx - 1, nx + 1); the pass of plane
// q computes the x-face q-1/2 (q >= 1) and, for 1 <= q <= nx, the y-face
// s+1/2 (1 <= t <= nz, s <= ny) and the z-face t+1/2 (1 <= s <= ny, t <=
// nz): exactly the live face sets of the reference's pre-pass, each once.
// A chunk that starts past plane 0 first loads the plane before it.
__global__ void __launch_bounds__(DT_NT)
qgd3d_dt_kernel(QGD3DParams P, const float* __restrict__ T,
                const float* __restrict__ ux, const float* __restrict__ uy,
                const float* __restrict__ uz, int cx, int mode,
                const float* __restrict__ dt_old, float* __restrict__ work,
                float* __restrict__ out) {
  __shared__ float yb[2][3][DY + 1][DZ];  // c, tc, uy of a plane's rows
  __shared__ float zb[2][3][DY];          // c, tc, uz of its z-halo lane
  __shared__ float slots[DT_NQ][DT_NT / 32];
  __shared__ bool last;
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * sy;
  const int t = blockIdx.x * DZ + tz, s = blockIdx.y * DY + ty;
  const int r0 = blockIdx.z * cx;
  const int re = r0 + cx - 1 < nx + 1 ? r0 + cx - 1 : nx + 1;
  const bool vs = P.varsc != 0;
  const bool si = s >= 1 && s <= ny, ti = t >= 1 && t <= nz;
  const bool yf = ti && s <= ny;      // owns a y-face s+1/2
  const bool zf = si && t <= nz;      // owns a z-face t+1/2
  const int sh = blockIdx.y * DY + DY;  // the halo row
  const bool hy = ty == 0 && ti && sh <= ny + 1;
  // lane tz < DY of warp 1: the z-halo cell (s0 + tz, t0 + DZ) of row tz
  const int zs = blockIdx.y * DY + tz, zt = blockIdx.x * DZ + DZ;
  const bool hz = ty == 1 && tz < DY && zs >= 1 && zs <= ny && zt <= nz + 1;
  const long cell = s * sy + t;

  auto load = [&](int q, bool full) {
    DtRaw a = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
    const long i = q * sx + cell;
    const bool in = full && q >= 1 && q <= nx;  // a plane with y/z faces
    const bool yc = in && ti && s <= ny + 1;    // a cell of a y-face
    const bool zc = in && si && t <= nz + 1;    // a cell of a z-face
    if ((si && ti) || yc || zc) a.T = T[i];
    if (si && ti) a.ux = ux[i];
    if (yc) a.uy = uy[i];
    if (zc) a.uz = uz[i];
    if (in && hy) {
      a.Ty = T[q * sx + sh * sy + t];
      a.uyy = uy[q * sx + sh * sy + t];
    }
    if (in && hz) {
      a.Tz = T[q * sx + zs * sy + zt];
      a.uzz = uz[q * sx + zs * sy + zt];
    }
    return a;
  };

  const float kid = vs ? -INFINITY : INFINITY;
  float v[DT_NQ] = {-INFINITY, -INFINITY, -INFINITY, kid, kid, kid};
  DtCell prev = {};
  const int qs = r0 > 0 ? r0 - 1 : r0;
  DtRaw cur = load(qs, qs == r0);
#pragma unroll 1
  for (int q = qs; q <= re; ++q) {
    const DtRaw nxt = q < re ? load(q + 1, true) : cur;
    const DtCell o = dt_cell(P, cur.T, cur.ux);
    if (q >= r0 && q >= 1 && si && ti) {
      // x-face q-1/2; coefficient ghosts zero-gradient at physical x ends
      const float ta = q == 1 && P.edge_lo ? o.tc : prev.tc;
      const float tb = q == nx + 1 && P.edge_hi ? prev.tc : o.tc;
      v[0] = nan_max(v[0], dt_wave(prev, o.u, o.c));
      v[3] = dt_fold(v[3], dt_coef(ta, tb), 3, vs);
    }
    if (q >= r0 && q >= 1 && q <= nx) {  // uniform in the block
      DtCell oy = o, oz = o;
      oy.u = cur.uy;
      oz.u = cur.uz;
      const int b = q & 1;
      yb[b][0][ty][tz] = o.c;
      yb[b][1][ty][tz] = o.tc;
      yb[b][2][ty][tz] = cur.uy;
      if (hy) {
        const DtCell h = dt_cell(P, cur.Ty, cur.uyy);
        yb[b][0][DY][tz] = h.c;
        yb[b][1][DY][tz] = h.tc;
        yb[b][2][DY][tz] = h.u;
      }
      if (hz) {
        const DtCell h = dt_cell(P, cur.Tz, cur.uzz);
        zb[b][0][tz] = h.c;
        zb[b][1][tz] = h.tc;
        zb[b][2][tz] = h.u;
      }
      // the z neighbour t+1: the next lane's, lane 31's the halo cell's
      float zc = __shfl_down_sync(0xffffffffu, o.c, 1);
      float ztc = __shfl_down_sync(0xffffffffu, o.tc, 1);
      float zu = __shfl_down_sync(0xffffffffu, cur.uz, 1);
      __syncthreads();
      if (tz == DZ - 1) {
        zc = zb[b][0][ty];
        ztc = zb[b][1][ty];
        zu = zb[b][2][ty];
      }
      if (yf) {
        const float yc = yb[b][0][ty + 1][tz], ytc = yb[b][1][ty + 1][tz];
        const float yu = yb[b][2][ty + 1][tz];
        const float ta = s == 0 ? ytc : o.tc;
        const float tb = s == ny ? o.tc : ytc;
        v[1] = nan_max(v[1], dt_wave(oy, yu, yc));
        v[4] = dt_fold(v[4], dt_coef(ta, tb), 4, vs);
      }
      if (zf) {
        const float ta = t == 0 ? ztc : o.tc;
        const float tb = t == nz ? o.tc : ztc;
        v[2] = nan_max(v[2], dt_wave(oz, zu, zc));
        v[5] = dt_fold(v[5], dt_coef(ta, tb), 5, vs);
      }
    }
    prev = o;
    cur = nxt;
  }

  dt_fold_block(v, vs, slots);
  const unsigned nb = gridDim.x * gridDim.y * gridDim.z;
  unsigned* ticket = reinterpret_cast<unsigned*>(work);
  float* parts = work + DT_HEAD;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const unsigned bid =
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
    for (int a = 0; a < DT_NQ; ++a) parts[DT_NQ * bid + a] = v[a];
    __threadfence();
    last = atomicAdd(ticket, 1u) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every block's partial (from L2), then the result
  const int tid = ty * DZ + tz;
#pragma unroll
  for (int a = 0; a < DT_NQ; ++a) v[a] = a < 3 ? -INFINITY : kid;
  for (unsigned i = tid; i < nb; i += DT_NT)
#pragma unroll
    for (int a = 0; a < DT_NQ; ++a)
      v[a] = dt_fold(v[a], __ldcg(parts + DT_NQ * i + a), a, vs);
  dt_fold_block(v, vs, slots);
  if (tid != 0) return;
  *ticket = 0u;  // the next launch on this workspace starts from 0
  float tmin = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float k = v[3 + a];
    tmin = nan_min(tmin, vs ? __fmul_rn(__fdiv_rn(P.alpha, k), P.d[a])
                            : __fmul_rn(k, P.d[a]));
  }
  const float m[3] = {v[0], v[1], v[2]};
  if (mode == DT_FOLD) {
#pragma unroll
    for (int a = 0; a < 3; ++a) out[a] = m[a];
    out[3] = -tmin;
    return;
  }
  out[0] = set_delta_t(P, m, tmin, dt_old[0]);
}

// setDeltaT on one reduced quad of qgd3d_dt_fold (max wave x, y, z, -min
// tau): one thread.
__global__ void qgd3d_dt_apply_kernel(QGD3DParams P,
                                      const float* __restrict__ quad,
                                      const float* __restrict__ dt_old,
                                      float* __restrict__ out) {
  const float m[3] = {quad[0], quad[1], quad[2]};
  out[0] = set_delta_t(P, m, -quad[3], dt_old[0]);
}

// One cell's base values at plane q from its frame values raw = p, T, ux,
// uy, uz, sc.  The coefficients take zero-gradient ghosts at physical
// boundaries: a y-ghost row, a z-ghost lane and an x-ghost plane take those
// of the interior cell beside them (read from the frames); a halo plane
// across a partition keeps its own.
__device__ __forceinline__ Base cell_base(const QGD3DParams& P,
                                          const Frames& F,
                                          const float* __restrict__ sc,
                                          const float (&raw)[6], int q, int s,
                                          int t, long sx, long sy) {
  Base c;
  const float T = raw[1];
  c.v[B_P] = raw[0];
  c.v[B_RHO] = raw[0] / (P.R * T);
  c.v[B_E] = P.Cv * T;
#pragma unroll
  for (int j = 0; j < 3; ++j) c.v[B_UX + j] = raw[2 + j];
  const float ke = raw[2] * raw[2] + raw[3] * raw[3] + raw[4] * raw[4];
  c.v[B_H] = P.CvR * T + 0.5f * ke;
  const int rc =
      q == 0 && P.edge_lo ? 1 : (q == P.nx + 1 && P.edge_hi ? P.nx : q);
  const int cs = clampi(s, 1, P.ny), ct = clampi(t, 1, P.nz);
  float cp = raw[0], cT = T, csc = raw[5];
  if (rc != q || cs != s || ct != t) {
    const long g = rc * sx + cs * sy + ct;
    cp = F.p[g];
    cT = F.T[g];
    csc = P.varsc ? sc[g] : 0.0f;
  }
  const Coef k = cell_coef(P, cp, cT, csc);
  c.v[B_MU] = k.mu;
  c.v[B_AU] = k.au;
  c.v[B_TC] = k.tc;
  return c;
}

// A plane's place in the period of the update's plane buffers.
template <int M>
struct Slot {
  static constexpr int value = M;
};

// The x-march (see the note at the top).  Block (bx, by, bz) owns the cells
// t0 = 1 + TZ*bx .. +TZ-1, s0 = 1 + TY*by .. +TY-1 of the planes r0 = 1 +
// cx*bz .. re.  Warp w < TY owns the tile's row s0 + w, a lane a cell; warps
// TY and TY + 1 the ring's rows s0 - 1 and s0 + TY; warp TY + 2 the ring's
// lanes t0 - 1 and t0 + TZ of each tile row (lanes 0 .. 2*TY - 1) and the
// four corners.  Cell (ry, lz) of the tile and its ring is the frame cell
// (s0 - 1 + ry, t0 - 1 + lz), index ry * WZ + lz of a shared plane.  Plane q
// of the march keeps its base values and the values of its cells' low y-
// faces (between a cell and the one before it along y) and low z-faces in
// the buffers of slot (q - r0 + 1) % 3; the x-faces' values of the plane
// being passed are in xv.  A face's values are published as the sums a + b
// of its two cells' values: with 0.5/2d for 1/2d, the tangential gradients
// are then the reference's xi differences bit for bit (halving is exact).
__global__ void __launch_bounds__(NT, UPDATE_MIN_BLOCKS)
qgd3d_update_kernel(QGD3DParams P, int cx, Frames F,
                    const float* __restrict__ sc,
                    const float* __restrict__ dt, float* __restrict__ pn,
                    float* __restrict__ Tn, float* __restrict__ uxn,
                    float* __restrict__ uyn, float* __restrict__ uzn,
                    float* __restrict__ side) {
  extern __shared__ float smem[];  // [3][B_NF][EXT] base values, then:
  float* const fv0 = smem + 3 * B_NF * EXT;  // [3][2 * NFV][EXT]
  float* const xv = fv0 + 3 * 2 * NFV * EXT;  // [NFV][EXT]
  float* const yfl = xv + NFV * EXT;          // [5][TY + 1][TZ]
  float* const zfl = yfl + 5 * YF;            // [5][TY][TZ + 1]
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * sy;
  const int s0 = 1 + blockIdx.y * TY, t0 = 1 + blockIdx.x * TZ;
  const int r0 = 1 + blockIdx.z * cx;
  const int re = r0 + cx - 1 < nx ? r0 + cx - 1 : nx;

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ry = lane % TY + 1, lz = lane < TY ? 0 : TZ + 1;  // the ring's lanes
  bool has = true;
  if (w < TY + 2) {
    ry = w < TY ? w + 1 : (w == TY ? 0 : TY + 1);
    lz = lane + 1;
  } else if (lane >= 2 * TY) {  // the corners; the lanes after them idle
    const int k = lane - 2 * TY;
    has = k < 4;
    ry = (k >> 1 & 1) * (TY + 1);
    lz = (k & 1) * (TZ + 1);
  }
  const bool tile = w < TY;
  // the faces a cell computes: its low y-face (the tile's rows and the
  // ring's far row), its low z-face (the tile's lanes and the ring's far
  // lane)
  const bool yface = has && ry >= 1 && lz >= 1 && lz <= TZ;
  const bool zface = has && ry >= 1 && ry <= TY && lz >= 1;
  const int i = ry * WZ + lz;
  // in-plane neighbours; a ring cell takes itself beyond the ring (its
  // values there are not read)
  const int iym = ry > 0 ? i - WZ : i, iyp = ry < TY + 1 ? i + WZ : i;
  const int izm = lz > 0 ? i - 1 : i, izp = lz < TZ + 1 ? i + 1 : i;
  // the frame cell, whose row or lane repeats the frame's last beyond it
  const int sf = s0 - 1 + ry, tf = t0 - 1 + lz;
  const int s = sf < ny + 1 ? sf : ny + 1, t = tf < nz + 1 ? tf : nz + 1;
  const bool live = tile && sf <= ny && tf <= nz;
  const long cell = s * sy + t;
  const long j = (long)(s - 1) * nz + (t - 1);  // its cell of `side`
  const float sdt = dt[0] * P.inv_vol;
  float hh[3];  // 0.5/2d: the tangential gradient of published sums
#pragma unroll
  for (int a = 0; a < 3; ++a) hh[a] = 0.5f * P.inv_2d[a];

  auto bb = [&](int m) { return smem + m * (B_NF * EXT); };
  auto fv = [&](int m) { return fv0 + m * (2 * NFV * EXT); };
  auto load = [&](float (&raw)[6], int q) {
    const long g = q * sx + cell;
    raw[0] = F.p[g];
    raw[1] = F.T[g];
#pragma unroll
    for (int k = 0; k < 3; ++k) raw[2 + k] = F.u[k][g];
    raw[5] = P.varsc ? sc[g] : 0.0f;
  };
  auto publish = [&](int m, const Base& c) {
    float* B = bb(m);
    if (has) {
#pragma unroll
      for (int f = 0; f < B_NF; ++f) B[f * EXT + i] = c.v[f];
    }
  };
  // the sums of this cell's low y- and z-faces of the plane in slot m, from
  // its own base values c and its neighbours' in shared memory
  auto face_values = [&](int m, const Base& c, float (&sum)[2 * NFV]) {
    const float* B = bb(m);
    float* V = fv(m);
#pragma unroll
    for (int k = 0; k < NFV; ++k) {
      const int f = face_field(k);
      sum[k] = B[f * EXT + iym] + c.v[f];
      sum[NFV + k] = B[f * EXT + izm] + c.v[f];
    }
    if (has) {
#pragma unroll
      for (int k = 0; k < 2 * NFV; ++k) V[k * EXT + i] = sum[k];
    }
  };

  float raw[6];   // the frame values of plane c+2, on their way
  Base bq[3];     // the base values of the planes, by slot
  float xq[3][5]; // the fluxes of the x-face q+1/2, by the slot of q
  load(raw, r0 - 1);
  bq[0] = cell_base(P, F, sc, raw, r0 - 1, s, t, sx, sy);
  publish(0, bq[0]);
  load(raw, r0);
  bq[1] = cell_base(P, F, sc, raw, r0, s, t, sx, sy);
  publish(1, bq[1]);
  load(raw, r0 + 1);
  __syncthreads();
  {
    float sum[2 * NFV];
    face_values(0, bq[0], sum);
  }

  // pass c (slot m0): the x-face c+1/2 and, from r0 to re, the y- and
  // z-faces of plane c and its update.  On entry the base values of planes
  // c and c+1 and the face values of c-1 and c (the pass r0 - 1: c-1 alone)
  // are published.
  auto pass = [&](auto slot, int c) {
    constexpr int m0 = decltype(slot)::value;
    constexpr int m1 = (m0 + 1) % 3, m2 = (m0 + 2) % 3;  // c+1; c+2 and c-1
    const Base& b0 = bq[m0];
    const Base& b1 = bq[m1];
    float sp[2 * NFV];  // this cell's face sums of plane c+1
    face_values(m1, b1, sp);
    if (has) {
#pragma unroll
      for (int k = 0; k < NFV; ++k) {
        const int f = face_field(k);
        xv[k * EXT + i] = b0.v[f] + b1.v[f];
      }
    }
    if (c + 2 <= re + 1) {
      bq[m2] = cell_base(P, F, sc, raw, c + 2, s, t, sx, sy);
      publish(m2, bq[m2]);
      if (c + 3 <= re + 1) load(raw, c + 3);
    }
    __syncthreads();  // the face values of c+1 and c+1/2, the base of c+2
    if (tile) {  // the x-face c+1/2
      float gt[2][NFV];
#pragma unroll
      for (int k = 0; k < NFV; ++k) {
        gt[0][k] = (xv[k * EXT + iyp] - xv[k * EXT + iym]) * hh[1];
        gt[1][k] = (xv[k * EXT + izp] - xv[k * EXT + izm]) * hh[2];
      }
      const Flux hi = face_flux<0>(P, b0.v, b1.v, gt);
      // ws/tau_f on the physical x-boundary faces: the qgdFlux p ghost of
      // this step
      if (live && ((c == 0 && P.edge_lo) || (c == nx && P.edge_hi)))
        side[(c == 0 ? 0 : (long)ny * nz) + j] = hi.ws / hi.tau;
#pragma unroll
      for (int k = 0; k < 5; ++k) xq[m0][k] = hi.f[k];
    }
    float yo[5], zo[5];  // this cell's low y- and z-face fluxes
    if (c >= r0) {  // uniform in the block
      const float* B = bb(m0);
      const float* Vm = fv(m2);
      const float* V0 = fv(m0);
      if (yface) {
        float gt[2][NFV], a[B_NF];
#pragma unroll
        for (int k = 0; k < NFV; ++k) {
          const float* m = Vm + k * EXT;
          const float* z = V0 + k * EXT;
          gt[0][k] = (sp[k] - m[i]) * hh[0];
          gt[1][k] = (z[izp] - z[izm]) * hh[2];
        }
#pragma unroll
        for (int f = 0; f < B_NF; ++f) a[f] = B[f * EXT + i - WZ];
        const Flux fl = face_flux<1>(P, a, b0.v, gt);
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          yfl[k * YF + (ry - 1) * TZ + lz - 1] = fl.f[k];
          yo[k] = fl.f[k];
        }
      }
      if (zface) {
        float gt[2][NFV], a[B_NF];
#pragma unroll
        for (int k = 0; k < NFV; ++k) {
          const float* m = Vm + (NFV + k) * EXT;
          const float* z = V0 + (NFV + k) * EXT;
          gt[0][k] = (sp[NFV + k] - m[i]) * hh[0];
          gt[1][k] = (z[iyp] - z[iym]) * hh[1];
        }
#pragma unroll
        for (int f = 0; f < B_NF; ++f) a[f] = B[f * EXT + i - 1];
        const Flux fl = face_flux<2>(P, a, b0.v, gt);
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          zfl[k * ZF + (ry - 1) * (TZ + 1) + lz - 1] = fl.f[k];
          zo[k] = fl.f[k];
        }
      }
    }
    __syncthreads();  // plane c's faces
    if (c >= r0 && live) {
      const int yl = (ry - 1) * TZ + lz - 1;
      const int zl = (ry - 1) * (TZ + 1) + lz - 1;
      float acc[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float* yk = yfl + k * YF + yl;
        const float* zk = zfl + k * ZF + zl;
        acc[k] = xq[m0][k] - xq[m2][k];
        acc[k] = acc[k] + (yk[TZ] - yo[k]);
        acc[k] = acc[k] + (zk[1] - zo[k]);
      }
      const float* ob = b0.v;
      const float rho = ob[B_RHO];
      const float ke =
          ob[B_UX] * ob[B_UX] + ob[B_UY] * ob[B_UY] + ob[B_UZ] * ob[B_UZ];
      const float rhoE = rho * (ob[B_E] + 0.5f * ke);
      const float rhon = rho - sdt * acc[0];
      const float inv_rhon = 1.0f / rhon;
      float un[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        un[k] = (rho * ob[B_UX + k] - sdt * acc[1 + k]) * inv_rhon;
      const float rhoEn = rhoE - sdt * acc[4];
      const float en = rhoEn * inv_rhon -
                       0.5f * (un[0] * un[0] + un[1] * un[1] + un[2] * un[2]);
      const float Tv = en * P.inv_Cv;
      const long i0 = c * sx + cell;
      pn[i0] = rhon * P.R * Tv;
      Tn[i0] = Tv;
      uxn[i0] = un[0];
      uyn[i0] = un[1];
      uzn[i0] = un[2];
    }
  };
  // the passes r0 - 1 .. re, three a trip so that every slot is a constant
  const int np = re - r0 + 2;
#pragma unroll 1
  for (int k = 0; k < np; k += 3) {
    pass(Slot<0>{}, r0 - 1 + k);
    if (k + 1 < np) pass(Slot<1>{}, r0 + k);
    if (k + 2 < np) pass(Slot<2>{}, r0 + 1 + k);
  }
}

// ---------------------------------------------------------------------------
// qgd3d_ghosts: every BC ghost of the five fresh frames in one launch
// ---------------------------------------------------------------------------
//
// The semantics are the sequential-axis padding of the reference kernel
// (qgdsolver_tpu/ops/fused_qgd3d.py:563-632) and of ghosts_reference_3d:
// x-ghost planes from the fresh interior (qgdFlux p from `side`, array
// values from `planes`), then y-ghost rows over every x, then z-ghost lanes
// over every x and y, so an edge or a corner takes the earlier axes' ghosts;
// inletOutlet switches on the nearest interior cell's outward velocity; a
// partition x end is left to the plane exchange.  Blocks never wait for each
// other, so each ghost cell is computed from interior cells alone: an x-y
// edge is the y-formula of two x-ghost values that its thread computes
// itself, a corner composes all three axes, and no ghost that the launch
// writes is read.  A thread owns one ghost cell of one field, so as many
// loads are in flight as in one launch an axis (PERF.md has both designs'
// times); consecutive threads take consecutive z along an x- or y-ghost
// row, which is written whole, and the two ends of a z-line.  A
// ghost none of whose inputs is an earlier axis's ghost (all but the edges
// and corners) loads them in straight-line code.  An extrapolated ghost
// reads the second interior layer: along an axis of one cell whose two
// ends are physical that layer is a ghost this launch writes, and
// supported() refuses the config.

__device__ __forceinline__ float bc_ghost(const BCEntry3& b, float in1,
                                          float in2, float d, float v,
                                          float un, int sd) {
  // nvcc's contraction of these formulas written out (a product added to a
  // loaded operand is one fma), so that a ghost rounds the same whether its
  // operands were loaded or composed in registers
  switch (b.kind) {
    case BC_SYM:
      return __fmul_rn(b.value, in1);
    case BC_EXTRAP:
      return __fmaf_rn(2.0f, in1, -in2);
    case BC_FIXED:
      return __fmaf_rn(2.0f, v, -in1);
    case BC_IO: {
      // inletOutlet: zeroGradient where the flow leaves, fixedValue where
      // it enters
      const bool outflow = sd == 0 ? (un < 0.0f) : (un > 0.0f);
      return outflow ? in1 : __fmaf_rn(2.0f, v, -in1);
    }
    case BC_GRAD:
      return __fmaf_rn(v, d, in1);
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

struct Ghosts3 {
  const float* __restrict__ planes;  // (n, ny, nz) x-side profiles
  const float* __restrict__ side;    // (2, ny, nz) ws/tau_f of the x ends
  OutFrames O;
};

// The x-ghost at end sd from its line's cells: in1, in2 the first and
// second interior layers, pv the end's plane value (b.prof >= 0), q the
// qgdFlux side value, un the line's x-velocity at the first layer.
__device__ __forceinline__ float x_formula(const BCEntry3& b, int sd,
                                           float in1, float in2, float pv,
                                           float q, float d, float un) {
  if (b.kind == BC_QGDFLUX)
    return sd == 0 ? __fmaf_rn(q, d, in1) : __fmaf_rn(-q, d, in1);
  return bc_ghost(b, in1, in2, d, b.prof >= 0 ? pv : b.value, un, sd);
}

// One end's BC entry of field f along axis a: sd is not a constant here,
// and indexing the params with it would copy them to local memory.
__device__ __forceinline__ BCEntry3 bc_at(const QGD3DParams& P, int f, int a,
                                          int sd) {
  return sd == 0 ? P.bc[f][a][0] : P.bc[f][a][1];
}

// Field F at frame cell (r, s, t), s and t interior, after the x phase: on
// a physical x end's ghost plane its x-ghost, from the interior; else the
// frame's own value (interior, or a partition's halo plane).
template <int F>
__device__ __forceinline__ float x_value(const QGD3DParams& P,
                                         const Ghosts3& G, int r, int s,
                                         int t) {
  const long sy = P.nz + 2, sx = (long)(P.ny + 2) * sy, c = s * sy + t;
  const float* fld = field_ptr(G.O, F);
  const bool lo = r == 0 && P.edge_lo;
  if (!lo && !(r == P.nx + 1 && P.edge_hi)) return fld[r * sx + c];
  const int sd = lo ? 0 : 1;
  const long r1 = lo ? 1 : P.nx, r2 = lo ? 2 : P.nx - 1;
  const long plane = (long)P.ny * P.nz, k = (long)(s - 1) * P.nz + (t - 1);
  const BCEntry3 b = bc_at(P, F, 0, sd);
  const float in1 = fld[r1 * sx + c], in2 = fld[r2 * sx + c];
  const float un = G.O.f[2][r1 * sx + c];
  const float pv = G.planes[(b.prof > 0 ? b.prof : 0) * plane + k];
  const float q = G.side[sd * plane + k];
  return x_formula(b, sd, in1, in2, pv, q, P.d[0], un);
}

// Field F's y-ghost on side sd at (r, t), t interior: the y-formula of two
// values after the x phase.  The second layer of an axis of one cell is
// the first (only an extrapolated ghost reads it).
template <int F>
__device__ __forceinline__ float y_ghost(const QGD3DParams& P,
                                         const Ghosts3& G, int r, int sd,
                                         int t) {
  const int nx = P.nx, ny = P.ny;
  const long sy = P.nz + 2, sx = (long)(ny + 2) * sy;
  const int l1 = sd == 0 ? 1 : ny;
  const int l2 = ny < 2 ? 1 : (sd == 0 ? 2 : ny - 1);
  const float* fld = field_ptr(G.O, F);
  // inletOutlet on an x-ghost plane switches on the edge interior plane
  const float un = G.O.f[3][clampi(r, 1, nx) * sx + l1 * sy + t];
  float a, b;
  if ((r == 0 && P.edge_lo) || (r == nx + 1 && P.edge_hi)) {
    a = x_value<F>(P, G, r, l1, t);
    b = x_value<F>(P, G, r, l2, t);
  } else {
    a = fld[r * sx + l1 * sy + t];
    b = fld[r * sx + l2 * sy + t];
  }
  const BCEntry3 e = bc_at(P, F, 1, sd);
  return bc_ghost(e, a, b, P.d[1], e.value, un, sd);
}

// Field F's z-ghost on side sd at (r, s): the z-formula of two values after
// the y phase.
template <int F>
__device__ __forceinline__ float z_ghost(const QGD3DParams& P,
                                         const Ghosts3& G, int r, int s,
                                         int sd) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * sy;
  const int l1 = sd == 0 ? 1 : nz;
  const int l2 = nz < 2 ? 1 : (sd == 0 ? 2 : nz - 1);
  const float* fld = field_ptr(G.O, F);
  const float un =
      G.O.f[4][clampi(r, 1, nx) * sx + clampi(s, 1, ny) * sy + l1];
  float a, b;
  if (s == 0 || s == ny + 1) {
    a = y_ghost<F>(P, G, r, s == 0 ? 0 : 1, l1);
    b = y_ghost<F>(P, G, r, s == 0 ? 0 : 1, l2);
  } else if ((r == 0 && P.edge_lo) || (r == nx + 1 && P.edge_hi)) {
    a = x_value<F>(P, G, r, s, l1);
    b = x_value<F>(P, G, r, s, l2);
  } else {
    a = fld[r * sx + s * sy + l1];
    b = fld[r * sx + s * sy + l2];
  }
  const BCEntry3 e = bc_at(P, F, 2, sd);
  return bc_ghost(e, a, b, P.d[2], e.value, un, sd);
}

// Thread k of field F's ghost cells: the x-ghosts (sd, s, t), then the
// y-ghosts (r, sd, t), then the z-ghosts (r, s, sd), the last index
// fastest.  A partition x end's threads return: the exchange fills it.
template <int F>
__device__ __forceinline__ void ghost_cell(const QGD3DParams& P,
                                           const Ghosts3& G, long k) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const long sy = nz + 2, sx = (long)(ny + 2) * sy;
  const long plane = (long)ny * nz;
  float* fld = field_ptr(G.O, F);
  if (k < 2 * plane) {
    const int sd = k < plane ? 0 : 1;
    if (!(sd == 0 ? P.edge_lo : P.edge_hi)) return;
    const long j = k - sd * plane;
    const int s = 1 + (int)(j / nz), t = 1 + (int)(j % nz);
    const int r = sd == 0 ? 0 : nx + 1;
    fld[r * sx + s * sy + t] = x_value<F>(P, G, r, s, t);
    return;
  }
  k -= 2 * plane;
  if (k < 2L * (nx + 2) * nz) {
    const long q = k / nz;
    const int t = 1 + (int)(k - q * nz), sd = (int)(q & 1), r = (int)(q >> 1);
    fld[r * sx + (sd == 0 ? 0 : ny + 1) * sy + t] = y_ghost<F>(P, G, r, sd, t);
    return;
  }
  k -= 2L * (nx + 2) * nz;
  if (k >= 2L * (nx + 2) * (ny + 2)) return;
  const long q = k >> 1;
  const int sd = (int)(k & 1), r = (int)(q / (ny + 2));
  const int s = (int)(q - (long)r * (ny + 2));
  fld[r * sx + s * sy + (sd == 0 ? 0 : nz + 1)] = z_ghost<F>(P, G, r, s, sd);
}

__global__ void __launch_bounds__(GT)
qgd3d_ghosts_kernel(QGD3DParams P, Ghosts3 G) {
  const long k = (long)blockIdx.x * GT + threadIdx.x;
  switch (blockIdx.y) {
    case 0: ghost_cell<0>(P, G, k); break;
    case 1: ghost_cell<1>(P, G, k); break;
    case 2: ghost_cell<2>(P, G, k); break;
    case 3: ghost_cell<3>(P, G, k); break;
    default: ghost_cell<4>(P, G, k);
  }
}

// qgd3d_dt's chunk of x-planes and grid on the current device: the chunk
// for the fewest planes marched by the busiest SM (waves of resident blocks
// times the planes a block loads, its plane before the chunk included).
// bps (optional) receives the resident blocks per SM.
cudaError_t dt3_grid(const QGD3DParams& P, dim3* grid, int* cx,
                     int* bps_out = nullptr) {
  static int sms[64] = {}, bps[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps[dev], qgd3d_dt_kernel, DT_NT, 0);
    if (e != cudaSuccess) {
      sms[dev] = 0;
      return e;
    }
  }
  const int gx = (P.nz + 2 + DZ - 1) / DZ, gy = (P.ny + 2 + DY - 1) / DY;
  const int planes = P.nx + 2;
  const long slots = (long)sms[dev] * (bps[dev] > 0 ? bps[dev] : 1);
  int best_c = planes;
  long best = -1;
  for (int chunks = 1; chunks <= planes; ++chunks) {
    const int c = (planes + chunks - 1) / chunks;
    if ((planes + c - 1) / c != chunks) continue;  // the same c as fewer
    const long cost = ((long)gx * gy * chunks + slots - 1) / slots * (c + 1);
    if (best < 0 || cost < best) {
      best = cost;
      best_c = c;
    }
  }
  *cx = best_c;
  *grid = dim3(gx, gy, (planes + best_c - 1) / best_c);
  if (bps_out) *bps_out = bps[dev];
  return cudaSuccess;
}

cudaError_t dt3_launch(const QGD3DParams& P, const float* T, const float* ux,
                       const float* uy, const float* uz, int mode,
                       const float* dt_old, float* work, float* out,
                       cudaStream_t st) {
  dim3 grid;
  int cx = 0;
  const cudaError_t e = dt3_grid(P, &grid, &cx);
  if (e != cudaSuccess) return e;
  qgd3d_dt_kernel<<<grid, dim3(DZ, DY), 0, st>>>(P, T, ux, uy, uz, cx, mode,
                                                 dt_old, work, out);
  return cudaGetLastError();
}

// The update's grid and chunk on the current device.  Its dynamic shared
// memory is above the 48 KB a launch gets without asking: allowed once on
// each device.  Of UPDATE_CHUNKS the chunk is the one whose waves of blocks
// (at the resident blocks an SM) times the passes of a block (the chunk's
// planes, its extra first pass and its set-up, about one pass) are fewest,
// as qgd3d_dt weighs its own: on an H100, 32 planes at 640x318x318 and
// 256x126x126 (16: 4% and 2% slower), 16 on a 128x126x126 K5 slab (21%
// faster than 32, which leaves 176 blocks for 132 SMs; PERF.md §6).  The
// chunk moves no bit.
cudaError_t update_grid(const QGD3DParams& P, dim3* grid, int* cx,
                        int* bps_out = nullptr) {
  static int sms[64] = {}, bps[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(qgd3d_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             UPDATE_SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps[dev], qgd3d_update_kernel, NT, UPDATE_SMEM);
    if (e != cudaSuccess) {
      sms[dev] = 0;
      return e;
    }
  }
  const long tiles = (long)((P.nz + TZ - 1) / TZ) * ((P.ny + TY - 1) / TY);
  const long slots = (long)sms[dev] * (bps[dev] > 0 ? bps[dev] : 1);
  long best = -1;
  for (const int c : UPDATE_CHUNKS) {
    const long chunks = (P.nx + c - 1) / c;
    const long cost = (tiles * chunks + slots - 1) / slots * (c + 2);
    if (best < 0 || cost < best) {
      best = cost;
      *cx = c;
    }
  }
  *grid = dim3((P.nz + TZ - 1) / TZ, (P.ny + TY - 1) / TY,
               (P.nx + *cx - 1) / *cx);
  if (bps_out) *bps_out = bps[dev];
  return cudaSuccess;
}


// ---------------------------------------------------------------------------
// qgd3d_smooth: the continuation of fvc::smooth, k rings per launch
// ---------------------------------------------------------------------------
//
// Replaces the XLA fvc_smooth the reference runs between K4's calls
// (qgdsolver_tpu/ops/fused_qgd3d.py:841-844), from its second ring on: the
// step's first ring comes from qgd3d_emit, and this kernel carries it to the
// fixed point of f <- max(f, nbr_max(f)/maxRatio) over the six face
// neighbours (a cell beyond a physical edge is the cell itself); it runs
// only when ring 1 raised a cell.  A launch runs k rings of the (nx, ny, nz)
// cells it reads (a frame's interior, or bare cells) into the sensor frame,
// ghosts edge-replicated, and sets the flag when the last ring raised a
// written cell; the host launches again while it is set.  As in
// qgd2d_smooth, ring j is valid on the block's region shrunk by j cells, the
// ring is smooth_ring.cuh's, and the result is the plain loop's bit for bit
// whatever k and however the rings are grouped.
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
// it reads.  A warp whose cells of the last k + 1 raw planes all are at
// least SMOOTH_TINY (every sensor: it is clamped at cqSc or above) takes the
// ring without its underflow test: the rings only raise a cell, and nb is
// at least the cell, so only the cell's own value decides whether the test
// can be skipped.  On the 3D varsc jet's continuation at 256x126x126 on an
// H100 the split took 0.090 ms for 4 rings against 0.106 with the test
// everywhere, and a layout of two 256-thread blocks a SM with z-neighbours
// by warp shuffle and two register planes a level took 0.101
// (ab_kernels.py, PERF.md).

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

// The K levels of one step with raw plane s in level 0's slot U: level j
// computes plane s - j; level K's cells of the chunk are written, and
// raised says whether the last ring raised one.  U = (s - first step) mod 3
// names the register slots: plane q of any level sits in slot
// (q - first step) mod 3.
template <int K, bool EDGE, int U, bool GUARD>
__device__ __forceinline__ void smooth3_levels(
    const QGD3DParams& P, const Smooth3& A, float (&pl)[K][3][S3R],
    const float* __restrict__ sp, int s, int x0, int y0, int z0,
    const bool (&yin)[S3R], bool zin, float inv, bool& raised) {
  const int tz = threadIdx.x, a0 = threadIdx.y * S3R;
  const int nx = P.nx;
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
      float nb = nan_max(nan_max(c, f[lo][i]), f[hi][i]);
      nb = nan_max(nb, nan_max(nan_max(yl, yh),
                               nan_max(q[i * S3W - 1], q[i * S3W + 1])));
      float v = smooth_ring<GUARD>(c, nb, P.smooth_ratio, inv);
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
}

// One step of the march with raw plane s arriving (fetched S3D - 1 steps
// ahead; plane s + S3D - 1 is fetched now).  run counts the newest raw
// planes whose cells of this warp all are at least SMOOTH_TINY: when the
// centres of all K levels' cells are among them, the levels skip the ring's
// underflow test.
template <int K, bool EDGE, int U>
__device__ __forceinline__ void smooth3_step(
    const QGD3DParams& P, const Smooth3& A, float (&pl)[K][3][S3R],
    float* __restrict__ ring, float* __restrict__ sp, int s, int x0, int y0,
    int z0, const bool (&yin)[S3R], bool zin, float inv, bool& raised,
    int& run) {
  const int tz = threadIdx.x, a0 = threadIdx.y * S3R;
  smooth3_fetch<EDGE>(P, A, ring, s + S3D - 1, y0, z0, yin, zin);
  __pipeline_wait_prior(S3D - 1);  // this thread's copies of plane s
  const float* raw = smooth3_raw(ring, s);
  const bool xin = s >= 0 && s < P.nx;
  bool big = true;
#pragma unroll
  for (int i = 0; i < S3R; ++i) {
    pl[0][U][i] = raw[i * S3Z];
    if (xin && (!EDGE || (yin[i] && zin)))
      big = big && pl[0][U][i] >= SMOOTH_TINY;
  }
  run = __all_sync(0xffffffffu, big) ? run + 1 : 0;
  if (run > K)
    smooth3_levels<K, EDGE, U, false>(P, A, pl, sp, s, x0, y0, z0, yin, zin,
                                      inv, raised);
  else
    smooth3_levels<K, EDGE, U, true>(P, A, pl, sp, s, x0, y0, z0, yin, zin,
                                     inv, raised);
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
  int run = 0;
  const int first = x0 - K, steps = A.cx + 2 * K;
  const float inv = smooth_inverse(P.smooth_ratio);
  float* ring = sp + 2 * S3P * K;
  for (int d = 0; d < S3D - 1; ++d)
    smooth3_fetch<EDGE>(P, A, ring, first + d, y0, z0, yin, zin);
  for (int n = 0; n < steps; n += 3) {
    smooth3_step<K, EDGE, 0>(P, A, pl, ring, sp, first + n, x0, y0, z0, yin,
                             zin, inv, raised, run);
    if (n + 1 < steps)
      smooth3_step<K, EDGE, 1>(P, A, pl, ring, sp, first + n + 1, x0, y0, z0,
                               yin, zin, inv, raised, run);
    if (n + 2 < steps)
      smooth3_step<K, EDGE, 2>(P, A, pl, ring, sp, first + n + 2, x0, y0, z0,
                               yin, zin, inv, raised, run);
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

// A launch's chunk of x-planes for a block that writes `tiles` (y, z) tiles
// and marches `extra` planes beyond its chunk: the fewest planes marched by
// the busiest SM (waves of resident blocks times the planes a block
// marches), given `slots` resident blocks on the card.
int march_chunk(int nx, long tiles, long slots, int extra) {
  int cx = nx;
  long best = -1;
  for (int chunks = 1; chunks <= nx; ++chunks) {
    const int c = (nx + chunks - 1) / chunks;
    if ((nx + c - 1) / c != chunks) continue;  // the same c as fewer
    const long cost = (tiles * chunks + slots - 1) / slots * (c + extra);
    if (best < 0 || cost < best) {
      best = cost;
      cx = c;
    }
  }
  return cx;
}

// The launch of K rings: its chunk of planes, which a block marches with K
// planes before and after it, and its grid.
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
  const dim3 tiles((P.nz + S3Z - 2 * K - 1) / (S3Z - 2 * K),
                   (P.ny + S3Y - 2 * K - 1) / (S3Y - 2 * K));
  A.cx = march_chunk(P.nx, (long)tiles.x * tiles.y,
                     (long)sms[dev] * (bps[dev] > 0 ? bps[dev] : 1), 2 * K);
  const dim3 grid(tiles.x, tiles.y, (P.nx + A.cx - 1) / A.cx);
  if (shape) {
    shape[0] = S3Y;
    shape[1] = S3Z;
    shape[2] = A.cx;
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

// ---------------------------------------------------------------------------
// qgd3d_smooth's fixed point: fvc::smooth to its end in three line sweeps
// ---------------------------------------------------------------------------
//
// Writes the rings' fixed point itself, in three launches, where the ring
// kernel above takes ~5 launches of 4 rings and a host read after each.
// With h(v) = RN(v / maxRatio) (smooth_div), monotone and h(v) <= v for
// v >= 0 (maxRatio >= 1), a ring is f <- max(f, h(f at each face
// neighbour)), and the rings of such an f reach
//
//   F(c) = max over cells d of h^n(f(d)),  n = |c - d|_1:
//
// every path of n faces from d carries the same chain of n roundings, and a
// longer chain gives less (h^m(v) <= h^n(v) for m >= n).  The max over the
// L1 ball factors into one pass an axis, F = S_x(S_y(S_z(f))), S_a(g)(c) =
// max over t of h^|t|(g(c + t e_a)), and S_a is a forward sweep t <- max(g,
// h(t)) along the axis followed by a backward one over its result (every
// term the second adds beside S_a's is one of S_a's with a longer chain).
// These are the rings' divisions and maxima in another order, so F is the
// ring loop's result bit for bit.  It holds for values that are finite with
// the sign bit clear: the first pass raises the flag at any other value,
// and the host then runs the ring loop, whose NaN region depends on its
// ring count.
//
// Each pass writes whole lines of the output frame, ghosts included: the z
// pass reads the input's cells (its ghost rows read the edge rows they
// copy), and the y and x passes sweep the output frame in place, each of
// its lines, so a ghost line of another axis, a copy of an edge line, stays
// its copy; a line's own ghosts are its end cells.  A block owns whole
// lines and holds them in registers before it writes one.  A line is cut
// into segments of L cells, one a thread: each sweep runs along the
// segment, then the segments hand their end values on in rounds until no
// end moves.  A carry u = h^k(c) entering a segment stops at the first cell
// it does not raise: that cell's value is at least u, and the next one's is
// at least h of it, at least h(u), so no later cell would be raised either.
// On the jet (maxRatio 1.1, the sensor in [0.05, 1]) no carry passes 32
// cells, so a sweep takes a few rounds.  The z pass gives a warp one
// row and a lane one segment, with the carries by shuffle, and stages its
// rows in shared memory so that its loads and stores are coalesced; the y
// and x passes give a thread one segment of one of the block's 16 or 32
// lines (neighbours along z: coalesced), with the carries through shared
// memory.  h keeps smooth_div's underflow test: a build that skipped it in
// blocks of cells at least SMOOTH_TINY held twice the code and more
// registers, and its y pass took 0.33 ms against 0.24.  What bounds the
// kernel is memory: each pass reads the cells and writes a frame (0.156 ms
// a pass at 640x318x318 at 3.35 TB/s), while ~6 dependent instructions a
// cell and sweep over 10^5 lines an axis hide under the loads; each pass
// takes 0.20-0.25 ms there on an H100 (PERF.md).

constexpr int FIX3_ROWS = 8;         // warps (rows) of a z-pass block
constexpr int FIX3_MAXN = 32 * 32;   // the longest line: z, 32 lanes of 32

struct Fix3Rows {
  const float* in;  // cell (0, 0, 0) of the input
  long sx, sy;      // its x and y strides (z: 1)
  float* out;       // the (nx+2, ny+2, nz+2) frame
  float* chg;
};

// The cells a thread holds (and the y and x passes' lines a block), as a
// type: the fixed point's kernels take it as their template argument, so
// that qgd3d_smooth_kernel<K> with an int K still names the ring kernel
// alone.
template <int L, int Z = 32>
struct Fix3L {
  static constexpr int value = L;
  static constexpr int lanes = Z;  // the y and x passes' lines a block
};

struct Fix3Cols {
  float* out;  // the frame, swept in place
  long sl;     // its stride along the swept axis
  long sb;     // its stride between the lines' groups (grid y)
  int n;       // cells along the swept axis
};

// The last live cell of a segment of cnt (>= 1) cells, with no register
// indexed by a variable.
template <int L>
__device__ __forceinline__ float fix3_last(const float (&v)[L], int cnt) {
  float e = v[0];
#pragma unroll
  for (int i = 1; i < L; ++i)
    if (i < cnt) e = v[i];
  return e;
}

template <int L>
__device__ __forceinline__ void fix3_forward(float (&v)[L], int cnt, float r,
                                             float y) {
#pragma unroll
  for (int i = 1; i < L; ++i)
    if (i < cnt) v[i] = nan_max(v[i], smooth_div<true>(v[i - 1], r, y));
}

template <int L>
__device__ __forceinline__ void fix3_backward(float (&v)[L], int cnt, float r,
                                              float y) {
#pragma unroll
  for (int i = L - 2; i >= 0; --i)
    if (i + 1 < cnt) v[i] = nan_max(v[i], smooth_div<true>(v[i + 1], r, y));
}

// The forward carry c of the segment before into this one, from its first
// cell on; true if it raised the last cell (the end this segment hands on).
template <int L>
__device__ __forceinline__ bool fix3_carry_forward(float (&v)[L], int cnt,
                                                   float c, float r, float y) {
  float u = smooth_div<true>(c, r, y);
  bool end = false;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i >= cnt || !(u > v[i])) break;
    v[i] = u;
    end = i == cnt - 1;
    u = smooth_div<true>(u, r, y);
  }
  return end;
}

// The backward carry c of the segment after into this one, from its last
// cell down; true if it raised the first cell.
template <int L>
__device__ __forceinline__ bool fix3_carry_backward(float (&v)[L], int cnt,
                                                    float c, float r,
                                                    float y) {
  float u = smooth_div<true>(c, r, y);
  bool end = false;
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    if (i >= cnt) continue;
    if (!(u > v[i])) break;
    v[i] = u;
    end = i == 0;
    u = smooth_div<true>(u, r, y);
  }
  return end;
}

// S_z of a z-pass warp's row: lane l holds cells l*L ..; fwd / bwd say
// whether a carry enters the segment from the lane before / after.  After
// round j lanes 0..j+1 hold their exact ends, so 31 rounds suffice.
template <int L>
__device__ __forceinline__ void fix3_row(float (&v)[L], int cnt, bool fwd,
                                         bool bwd, float r, float y) {
  const unsigned all = 0xffffffffu;
  fix3_forward<L>(v, cnt, r, y);
  for (int round = 0; round < 31; ++round) {
    const float c = __shfl_up_sync(all, fix3_last(v, cnt), 1);
    const bool moved = fwd && fix3_carry_forward<L>(v, cnt, c, r, y);
    if (!__any_sync(all, moved)) break;
  }
  fix3_backward<L>(v, cnt, r, y);
  for (int round = 0; round < 31; ++round) {
    const float c = __shfl_down_sync(all, v[0], 1);
    const bool moved = bwd && fix3_carry_backward<L>(v, cnt, c, r, y);
    if (!__any_sync(all, moved)) break;
  }
}

// The z pass: a warp a row of the output frame ((nx+2)(ny+2) of them), its
// lanes C::value cells each; the flag when a cell read is not finite or
// has its sign bit set.
template <class C>
__global__ void __launch_bounds__(32 * FIX3_ROWS)
qgd3d_smooth_kernel(QGD3DParams P, Fix3Rows A) {
  constexpr int L = C::value;
  // a row staged with a pad after each segment: lane l reads its segment
  // at l * (L + 1), free of bank conflicts
  __shared__ float stage[FIX3_ROWS][32 * (L + 1)];
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x, nz = P.nz, wy = P.ny + 2;
  const long row = (long)blockIdx.x * FIX3_ROWS + threadIdx.y;
  if (row >= (long)(P.nx + 2) * wy) return;  // the whole warp
  const int xf = (int)(row / wy), yf = (int)(row - (long)xf * wy);
  const int cx = min(max(xf - 1, 0), P.nx - 1);
  const int cy = min(max(yf - 1, 0), P.ny - 1);
  const float* src = A.in + cx * A.sx + cy * A.sy;
  float* s = stage[threadIdx.y];
  float tmp[L];
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (lane + 32 * k < nz) tmp[k] = src[lane + 32 * k];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int e = lane + 32 * k;
    if (e < nz) s[e + e / L] = tmp[k];
  }
  __syncwarp();
  const int cnt = min(L, nz - lane * L);  // <= 0: a lane past the row
  float v[L];
  bool bad = false;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    v[i] = 1.0f;
    if (i < cnt) {
      v[i] = s[lane * (L + 1) + i];
      // the sign bit, or an exponent of all ones (an infinity or NaN)
      const unsigned b = __float_as_uint(v[i]);
      bad = bad || (b >> 31) || (b & 0x7f800000u) == 0x7f800000u;
    }
  }
  if (__any_sync(all, bad) && lane == 0) *A.chg = 1.0f;
  const float r = P.smooth_ratio, y = smooth_inverse(r);
  const bool fwd = lane > 0 && cnt > 0;
  const bool bwd = cnt > 0 && (lane + 1) * L < nz;
  fix3_row<L>(v, cnt, fwd, bwd, r, y);
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (i < cnt) s[lane * (L + 1) + i] = v[i];
  __syncwarp();
  float* dst = A.out + row * (nz + 2);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int e = lane + 32 * k;
    if (e < nz) dst[e + 1] = s[e + e / L];
  }
  if (lane == 0) dst[0] = s[0];
  if (lane == 1) dst[nz + 1] = s[nz - 1 + (nz - 1) / L];
}

// S_a of a block's Z lines: thread (w, l) holds segment w of line l; ends
// passes the segments' ends (forward) or starts (backward) on.  After round
// j segments 0..j+1 hold their exact ends, so W - 1 rounds suffice.
template <int L, int Z>
__device__ __forceinline__ void fix3_cols(float (&v)[L], int cnt, float* ends,
                                          int l, int w, int W, float r,
                                          float y) {
  fix3_forward<L>(v, cnt, r, y);
  for (int round = 0; round + 1 < W; ++round) {
    ends[w * Z + l] = fix3_last(v, cnt);
    __syncthreads();
    const bool moved =
        w > 0 &&
        fix3_carry_forward<L>(v, cnt, ends[(w - 1) * Z + l], r, y);
    if (!__syncthreads_or(moved)) break;
  }
  fix3_backward<L>(v, cnt, r, y);
  for (int round = 0; round + 1 < W; ++round) {
    ends[w * Z + l] = v[0];
    __syncthreads();
    const bool moved =
        w + 1 < W &&
        fix3_carry_backward<L>(v, cnt, ends[(w + 1) * Z + l], r, y);
    if (!__syncthreads_or(moved)) break;
  }
}

// The threads of a y- or x-pass block at most: two blocks an SM hold their
// cells in registers (48 each; one block of 32 cells a thread, which spill
// less at 64).
constexpr int FIX3_COLS_THREADS = 640;

// The y or x pass, in place: thread (w, l) of block (bx, g), w = its index
// over Z, sweeps the frame's line at g * sb + Z * bx + l along the axis of
// stride sl, its cells 1 + w * L .. (L = C::value, Z = C::lanes); a thread
// past the frame's z extent only keeps time.
template <class C>
__global__ void __launch_bounds__(FIX3_COLS_THREADS, C::value > 16 ? 1 : 2)
qgd3d_smooth_kernel(QGD3DParams P, Fix3Cols A) {
  constexpr int L = C::value, Z = C::lanes;
  __shared__ float ends[FIX3_COLS_THREADS];
  const int l = threadIdx.x % Z, w = threadIdx.x / Z, W = blockDim.x / Z;
  const int n = A.n, zf = blockIdx.x * Z + l;
  const bool live = zf < P.nz + 2;
  float* line = A.out + blockIdx.y * A.sb + (live ? zf : 0);
  float* seg = line + (long)(1 + w * L) * A.sl;
  const int cnt = min(L, n - w * L);
  float v[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    v[i] = 1.0f;
    if (live && i < cnt) v[i] = seg[i * A.sl];
  }
  __syncthreads();  // every cell read before any is written
  fix3_cols<L, Z>(v, cnt, ends, l, w, W, P.smooth_ratio,
                  smooth_inverse(P.smooth_ratio));
  if (!live) return;
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (i < cnt) seg[i * A.sl] = v[i];
  if (w == 0) line[0] = v[0];
  if (w == W - 1) line[(long)(n + 1) * A.sl] = fix3_last(v, cnt);
}

// The z pass's cells a lane: the fewest of FIX3_ROW_L for 32 segments to
// cover nz (0: none does).
constexpr int FIX3_ROW_L[] = {1, 2, 4, 8, 12, 16, 24, 32};

template <int L>
cudaError_t fix3_rows_launch(const QGD3DParams& P, const Fix3Rows& A,
                             cudaStream_t st) {
  const long rows = (long)(P.nx + 2) * (P.ny + 2);
  const unsigned blocks = (unsigned)((rows + FIX3_ROWS - 1) / FIX3_ROWS);
  qgd3d_smooth_kernel<Fix3L<L>><<<blocks, dim3(32, FIX3_ROWS), 0, st>>>(P, A);
  return cudaGetLastError();
}

int fix3_row_cells(int nz) {
  for (int L : FIX3_ROW_L)
    if (32 * L >= nz) return L;
  return 0;
}

cudaError_t fix3_rows(const QGD3DParams& P, const Fix3Rows& A,
                      cudaStream_t st) {
  switch (fix3_row_cells(P.nz)) {
    case 1: return fix3_rows_launch<1>(P, A, st);
    case 2: return fix3_rows_launch<2>(P, A, st);
    case 4: return fix3_rows_launch<4>(P, A, st);
    case 8: return fix3_rows_launch<8>(P, A, st);
    case 12: return fix3_rows_launch<12>(P, A, st);
    case 16: return fix3_rows_launch<16>(P, A, st);
    case 24: return fix3_rows_launch<24>(P, A, st);
    case 32: return fix3_rows_launch<32>(P, A, st);
    default: return cudaErrorInvalidValue;
  }
}

// The y and x passes' launch for lines of n cells: L cells a thread and Z
// lines a block ({0, 0} where none fits): the most lines a block (32, else
// 16; neighbours along z, so rows of 128 or 64 B) whose segments of at most
// 16 cells fit FIX3_COLS_THREADS threads, else 32 cells and 16 lines.  On
// the shocked jet at 640x318x318 on an H100 the y pass (318 cells: L 16, Z
// 32) took 0.20 ms against 0.24 with L 8, Z 16; the x pass (640 cells: L
// 16, Z 16) 0.25 ms against 0.38 with L 32, Z 32 (which spill at 48
// registers) and 0.34-0.43 with one block of up to 1024 threads an SM
// (PERF.md).
struct Fix3Shape {
  int L, Z;
};

constexpr Fix3Shape FIX3_COL_SHAPES[] = {{8, 32}, {16, 32}, {16, 16},
                                         {32, 16}};

Fix3Shape fix3_col_shape(int n) {
  for (const Fix3Shape& c : FIX3_COL_SHAPES)
    if ((n + c.L - 1) / c.L * c.Z <= FIX3_COLS_THREADS) return c;
  return {0, 0};
}

template <int L, int Z>
cudaError_t fix3_cols_launch(const QGD3DParams& P, const Fix3Cols& A,
                             int groups, cudaStream_t st) {
  qgd3d_smooth_kernel<Fix3L<L, Z>>
      <<<dim3((P.nz + 2 + Z - 1) / Z, groups), Z * ((A.n + L - 1) / L), 0,
         st>>>(P, A);
  return cudaGetLastError();
}

cudaError_t fix3_cols(const QGD3DParams& P, const Fix3Cols& A, int groups,
                      cudaStream_t st) {
  const Fix3Shape c = fix3_col_shape(A.n);
  switch (c.L * 100 + c.Z) {
    case 832: return fix3_cols_launch<8, 32>(P, A, groups, st);
    case 1632: return fix3_cols_launch<16, 32>(P, A, groups, st);
    case 1616: return fix3_cols_launch<16, 16>(P, A, groups, st);
    case 3216: return fix3_cols_launch<32, 16>(P, A, groups, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// qgd3d_emit: the raw sensor of the fresh frames, its first fvc::smooth ring
// and the change flag, in one launch (qgd3d_sensor: the raw sensor alone)
// ---------------------------------------------------------------------------
//
// Replaces the raw sensor that the TPU kernel emits in-kernel
// (qgdsolver_tpu/ops/fused_qgd3d.py:537-557) and the first ring of the XLA
// fvc_smooth between its calls (:841-844).  At each interior cell: rho =
// p*(1/(R*T)) of the fresh frames, zero-gradient beyond a physical boundary
// (the cell itself) and the exchanged halo plane across a partition x end;
// the raw varScModel5 sensor clip(rC*|grad rho|*h/rho + (1-rC)*sc, minSc,
// maxSc) floored at cqSc, relaxed against the current sensor frame sc; and
// ring 1 of fvc::smooth over the raw sensor (a neighbour beyond a physical
// edge is the cell itself).  EMIT_S1 writes ring 1 as the sensor frame
// (ghosts edge-replicated) and sets the flag where it raised a cell, which
// needs both x ends physical; EMIT_RAW writes the raw cells.  EMIT_RAW alone
// is qgd3d_sensor: K5's slabs, whose ring 1 crosses the partition, smooth
// their raw sensor with the plain rings.
//
// It reads three frames (p, T, sc) and writes one, so bytes would bound it;
// on the card its arithmetic does (a thread a cell would compute each rho
// seven times, and a second launch would read the raw sensor back for ring
// 1).  A block owns an EY x EZ (y, z) tile and marches a
// chunk of x-planes: at step s it stages rho of plane s over the tile and
// two rings in shared memory (each rho once a block), computes the raw
// sensor of plane s - 2 over the tile and one ring, and ring 1 of plane
// s - 4 over the tile, each from planes earlier steps wrote, so one barrier
// a step serves all three (four planes of each in shared memory); p and T
// of the next plane and sc of the next raw plane are loaded into registers
// while a plane is computed.  rho = p*(1/(R*T)) rounds as the plain
// version's; the raw sensor's products and sums too, but its division and
// square root are the hardware's approximations (a relative error of a few
// 2^-24): the correctly rounded ones took 0.075 ms a call against
// 0.051-0.055 at 256x126x126 on an H100 (ab_kernels.py, PERF.md), and the
// plain version is met within rel 1e-6.  The clamps propagate NaN, as torch.clamp does;
// the ring is smooth_ring.cuh's, on the kernel's own raw sensor, so ring 1
// and its flag are the plain ring's of that raw sensor bit for bit.  Both
// modes run the same code up to the stores, so their raw bits are the
// same.

constexpr int EZ = 32;                           // tile lanes (z): a warp
constexpr int EY = 16;                           // tile rows (y)
constexpr int ENT = EZ * EY;                     // threads of a block
constexpr int ERW = EZ + 4;                      // staged rho lanes
constexpr int ERC = (EY + 4) * ERW;              // staged rho cells a plane
constexpr int ESW = EZ + 2;                      // raw sensor lanes
constexpr int ESC = (EY + 2) * ESW;              // raw sensor cells a plane
constexpr int ERS = (ERC + ENT - 1) / ENT;       // rho cells a thread stages
constexpr int ESS = (ESC + ENT - 1) / ENT;       // raw cells a thread computes
enum { EMIT_RAW = 1, EMIT_S1 = 2 };

struct Emit3 {
  const float* __restrict__ p;
  const float* __restrict__ T;
  const float* __restrict__ sc;
  float* __restrict__ raw;  // (nx, ny, nz) (EMIT_RAW)
  float* __restrict__ s1;   // the (nx+2, ny+2, nz+2) frame (EMIT_S1)
  float* __restrict__ chg;  // zeroed before the launch (EMIT_S1)
  int cx;                   // planes a block writes
};

// sqrt by the hardware's approximation (one instruction, a relative error
// near 2^-23)
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The raw sensor from the central rho differences along each axis, the
// cell's rho and its current sensor.
__device__ __forceinline__ float raw_sensor3(const QGD3DParams& P, float dx,
                                             float dy, float dz, float r,
                                             float sc) {
  const float gx = __fmul_rn(dx, P.inv_2d[0]);
  const float gy = __fmul_rn(dy, P.inv_2d[1]);
  const float gz = __fmul_rn(dz, P.inv_2d[2]);
  const float g2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             __fmul_rn(gz, gz));
  const float v = __fadd_rn(
      __fmul_rn(P.rC, __fdividef(__fmul_rn(sqrt_approx(g2), P.h_cell), r)),
      __fmul_rn(P.one_m_rC, sc));
  return nan_max(nan_min(nan_max(v, P.minSc), P.maxSc), P.cqSc);
}

template <int MODE>
__global__ void __launch_bounds__(ENT, 2)
qgd3d_emit_kernel(QGD3DParams P, Emit3 A) {
  __shared__ float rho[4][ERC];
  __shared__ float raw[4][ESC];
  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * EZ + tz;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int wy = nz + 2;
  const long wx = (long)(ny + 2) * wy;
  const int x0 = blockIdx.z * A.cx;
  const int y0 = blockIdx.y * EY, z0 = blockIdx.x * EZ;
  // the frame plane of plane r: the edge plane beyond a physical x end (rho
  // is zero-gradient there), the halo plane across a partition end
  const int xlo = P.edge_lo ? 1 : 0, xhi = P.edge_hi ? nx : nx + 1;
  // this thread's staged rho cells and raw cells: their place in a frame
  // plane (clamped into the interior: zero-gradient along y and z)
  int roff[ERS], soff[ESS];
  bool sin[ESS];
#pragma unroll
  for (int k = 0; k < ERS; ++k) {
    const int n = tid + k * ENT, i = n / ERW, j = n % ERW;
    roff[k] = clampi(y0 - 1 + i, 1, ny) * wy + clampi(z0 - 1 + j, 1, nz);
  }
#pragma unroll
  for (int k = 0; k < ESS; ++k) {
    const int n = tid + k * ENT, i = n / ESW, j = n % ESW;
    const int y = y0 - 1 + i, z = z0 - 1 + j;
    sin[k] = n < ESC && y >= 0 && y < ny && z >= 0 && z < nz;
    soff[k] = clampi(y + 1, 1, ny) * wy + clampi(z + 1, 1, nz);
  }
  const int y = y0 + ty, z = z0 + tz;
  const bool cin = y < ny && z < nz;
  const int c = (ty + 1) * ESW + tz + 1;  // this thread's cell in a raw plane
  const float inv = smooth_inverse(P.smooth_ratio);
  bool raised = false;
  float pp[ERS], tt[ERS], ss[ESS];
  // step s: rho of plane s, the raw sensor of plane s - 2 and ring 1 of
  // plane s - 4, each from planes that earlier steps wrote, so one barrier
  // a step serves all three (four slots of each: plane q in slot q & 3)
  const int first = x0 - 2, top = x0 + A.cx + 1;  // the planes of rho
  {
    const long b = clampi(first + 1, xlo, xhi) * wx;
#pragma unroll
    for (int k = 0; k < ERS; ++k)
      if (tid + k * ENT < ERC) {
        pp[k] = A.p[b + roff[k]];
        tt[k] = A.T[b + roff[k]];
      }
  }
  for (int s = first; s <= top + 2; ++s) {
    // rho of plane s, then the loads of plane s + 1
    if (s <= top) {
      float* R = rho[s & 3];
#pragma unroll
      for (int k = 0; k < ERS; ++k)
        if (tid + k * ENT < ERC)
          R[tid + k * ENT] =
              __fmul_rn(pp[k], __frcp_rn(__fmul_rn(P.R, tt[k])));
      if (s < top) {
        const long b = clampi(s + 2, xlo, xhi) * wx;
#pragma unroll
        for (int k = 0; k < ERS; ++k)
          if (tid + k * ENT < ERC) {
            pp[k] = A.p[b + roff[k]];
            tt[k] = A.T[b + roff[k]];
          }
      }
    }
    // the raw sensor of plane r = s - 2 (sc of plane r is in ss)
    const int r = s - 2;
    if (r >= x0 - 1 && r >= 0 && r < nx) {
      const float* Rm = rho[(r - 1) & 3];
      const float* R0 = rho[r & 3];
      const float* Rp = rho[(r + 1) & 3];
#pragma unroll
      for (int k = 0; k < ESS; ++k) {
        if (!sin[k]) continue;
        const int n = tid + k * ENT;
        const int q = (n / ESW + 1) * ERW + n % ESW + 1;
        raw[r & 3][n] = raw_sensor3(
            P, __fsub_rn(Rp[q], Rm[q]), __fsub_rn(R0[q + ERW], R0[q - ERW]),
            __fsub_rn(R0[q + 1], R0[q - 1]), R0[q], ss[k]);
      }
    }
    // sc of plane s - 1 for the next step's raw sensor
    {
      const long b = clampi(s, 1, nx) * wx;
#pragma unroll
      for (int k = 0; k < ESS; ++k)
        if (sin[k]) ss[k] = A.sc[b + soff[k]];
    }
    // ring 1 of plane x = s - 4
    const int x = s - 4;
    if (x >= x0 && x < x0 + A.cx && x < nx && cin) {
      const float* F = raw[x & 3];
      const float f = F[c];
      if (MODE & EMIT_RAW) A.raw[((long)x * ny + y) * nz + z] = f;
      if (MODE & EMIT_S1) {
        const float xl = x > 0 ? raw[(x - 1) & 3][c] : f;
        const float xh = x < nx - 1 ? raw[(x + 1) & 3][c] : f;
        const float yl = y > 0 ? F[c - ESW] : f;
        const float yh = y < ny - 1 ? F[c + ESW] : f;
        const float zl = z > 0 ? F[c - 1] : f;
        const float zh = z < nz - 1 ? F[c + 1] : f;
        const float nb = nan_max(nan_max(nan_max(f, xl), xh),
                                 nan_max(nan_max(yl, yh), nan_max(zl, zh)));
        const float v = smooth_ring<true>(f, nb, P.smooth_ratio, inv);
        smooth3_put(P, A.s1, x, y, z, v);
        if (v > f) raised = true;
      }
    }
    __syncthreads();
  }
  if (MODE & EMIT_S1) {
    if (__syncthreads_or(raised) && tid == 0) A.chg[0] = 1.0f;
  }
}

// The emit launch's chunk of x-planes (a block steps over two planes before
// it and four after it) and grid on the current device; bps (optional)
// receives the resident blocks per SM.
template <int MODE>
cudaError_t emit3_grid(const QGD3DParams& P, dim3* grid, int* cx,
                       int* bps_out = nullptr) {
  static int sms[64] = {}, bps[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps[dev], qgd3d_emit_kernel<MODE>, ENT, 0);
    if (e != cudaSuccess) {
      sms[dev] = 0;
      return e;
    }
  }
  const long ty = (P.ny + EY - 1) / EY, tz = (P.nz + EZ - 1) / EZ;
  *cx = march_chunk(P.nx, ty * tz,
                    (long)sms[dev] * (bps[dev] > 0 ? bps[dev] : 1), 6);
  *grid = dim3((unsigned)tz, (unsigned)ty, (P.nx + *cx - 1) / *cx);
  if (bps_out) *bps_out = bps[dev];
  return cudaSuccess;
}

template <int MODE>
cudaError_t emit3_launch(const QGD3DParams& P, Emit3 A, cudaStream_t st) {
  dim3 grid;
  const cudaError_t e = emit3_grid<MODE>(P, &grid, &A.cx);
  if (e != cudaSuccess) return e;
  qgd3d_emit_kernel<MODE><<<grid, dim3(EZ, EY), 0, st>>>(P, A);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The dt workspace's partial quads: one per block of the launch on the
// current device (-1 on a CUDA error).  The workspace holds DT_HEAD floats
// (the ticket, 0 before the first launch) and DT_NQ per partial.
int qgd3d_dt_partials(const QGD3DParams* prm) {
  dim3 g;
  int cx = 0;
  if (dt3_grid(*prm, &g, &cx) != cudaSuccess) return -1;
  return static_cast<int>(g.x * g.y * g.z);
}

int qgd3d_dt(const QGD3DParams* prm, const float* T, const float* ux,
             const float* uy, const float* uz, const float* dt_old,
             float* work, float* dt_new, void* stream) {
  return static_cast<int>(dt3_launch(*prm, T, ux, uy, uz, DT_FULL, dt_old,
                                     work, dt_new,
                                     static_cast<cudaStream_t>(stream)));
}

// This slab's dt folded to the quad (max wave x, y, z, -min tau): what a
// MAX all-reduce over the ranks combines.
int qgd3d_dt_fold(const QGD3DParams* prm, const float* T, const float* ux,
                  const float* uy, const float* uz, float* work, float* quad,
                  void* stream) {
  return static_cast<int>(dt3_launch(*prm, T, ux, uy, uz, DT_FOLD, nullptr,
                                     work, quad,
                                     static_cast<cudaStream_t>(stream)));
}

// setDeltaT on a reduced quad of qgd3d_dt_fold.
int qgd3d_dt_apply(const QGD3DParams* prm, const float* quad,
                   const float* dt_old, float* dt_new, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qgd3d_dt_apply_kernel<<<1, 1, 0, st>>>(*prm, quad, dt_old, dt_new);
  return static_cast<int>(cudaGetLastError());
}

// The dt launch's shape on the current device: out = {tile rows (y), tile
// lanes (z), chunk planes, blocks, resident blocks per SM}.
int qgd3d_dt_shape(const QGD3DParams* prm, int* out) {
  dim3 g;
  int cx = 0;
  const cudaError_t e = dt3_grid(*prm, &g, &cx, &out[4]);
  out[0] = DY;
  out[1] = DZ;
  out[2] = cx;
  out[3] = static_cast<int>(g.x * g.y * g.z);
  return static_cast<int>(e);
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
  dim3 grid;
  int cx = 0;
  const cudaError_t e = update_grid(*prm, &grid, &cx);
  if (e != cudaSuccess) return static_cast<int>(e);
  qgd3d_update_kernel<<<grid, NT, UPDATE_SMEM, st>>>(
      *prm, cx, F, sc, dt, pn, Tn, uxn, uyn, uzn, side);
  return static_cast<int>(cudaGetLastError());
}

// The update's launch at prm's shape on the current device: out = {TY, TZ,
// chunk planes, dynamic shared bytes per block, resident blocks per SM}.
int qgd3d_update_launch(const QGD3DParams* prm, int* out) {
  dim3 grid;
  const cudaError_t e = update_grid(*prm, &grid, &out[2], &out[4]);
  out[0] = TY;
  out[1] = TZ;
  out[3] = UPDATE_SMEM;
  return static_cast<int>(e);
}

// The raw varScModel5 sensor of the fresh frames alone, (nx, ny, nz) cells
// (qgd3d_emit_kernel's EMIT_RAW mode; either x end may be a partition).
int qgd3d_sensor(const QGD3DParams* prm, const float* p, const float* T,
                 const float* sc, float* out, void* stream) {
  const Emit3 A = {p, T, sc, out, nullptr, nullptr, 0};
  return static_cast<int>(
      emit3_launch<EMIT_RAW>(*prm, A, static_cast<cudaStream_t>(stream)));
}

// The raw sensor (into raw, unless it is null), its first fvc::smooth ring
// into the frame s1, ghosts edge-replicated, and chg <- 1 if the ring raised
// a cell, else 0, in one launch.  Both x ends must be physical.
int qgd3d_emit(const QGD3DParams* prm, const float* p, const float* T,
               const float* sc, float* raw, float* s1, float* chg,
               void* stream) {
  if (!prm->edge_lo || !prm->edge_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(chg, 0, sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Emit3 A = {p, T, sc, raw, s1, chg, 0};
  e = raw ? emit3_launch<EMIT_RAW | EMIT_S1>(*prm, A, st)
          : emit3_launch<EMIT_S1>(*prm, A, st);
  return static_cast<int>(e);
}

// qgd3d_emit's launch at prm's shape on the current device: out = {tile rows
// (y), tile lanes (z), chunk planes, blocks, resident blocks per SM}.
int qgd3d_emit_shape(const QGD3DParams* prm, int* out) {
  dim3 g;
  const cudaError_t e = emit3_grid<EMIT_S1>(*prm, &g, &out[2], &out[4]);
  out[0] = EY;
  out[1] = EZ;
  out[3] = static_cast<int>(g.x * g.y * g.z);
  return static_cast<int>(e);
}

// Every ghost of the five fresh frames (qgd3d_ghosts_kernel), one launch.
int qgd3d_ghosts(const QGD3DParams* prm, const float* planes,
                 const float* side, float* p, float* T, float* ux, float* uy,
                 float* uz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Ghosts3 G;
  G.planes = planes;
  G.side = side;
  G.O.f[0] = p;
  G.O.f[1] = T;
  G.O.f[2] = ux;
  G.O.f[3] = uy;
  G.O.f[4] = uz;
  const long nx = prm->nx, ny = prm->ny, nz = prm->nz;
  const long cells = 2 * (ny * nz + (nx + 2) * nz + (nx + 2) * (ny + 2));
  qgd3d_ghosts_kernel<<<dim3((unsigned)((cells + GT - 1) / GT), 5), GT, 0,
                        st>>>(*prm, G);
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

// fvc::smooth's fixed point of the (nx, ny, nz) cells at in (cell (x, y, z)
// at in[x * sx + y * sy + z]) into the frame out, ghosts edge-replicated, in
// three launches (z, y, x); chg <- 1 if a cell is not finite or has its sign
// bit set (out is then not the rings' fixed point), else 0.  Every axis at
// most FIX3_MAXN cells, and maxRatio at least 1.
int qgd3d_smooth_fixed(const QGD3DParams* prm, const float* in, long sx,
                       long sy, float* out, float* chg, void* stream) {
  const QGD3DParams& P = *prm;
  if (P.nx > FIX3_MAXN || P.ny > FIX3_MAXN || P.nz > FIX3_MAXN ||
      !(P.smooth_ratio >= 1.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(chg, 0, sizeof(float), st);
  const long wz = P.nz + 2, wyz = (long)(P.ny + 2) * wz;
  if (e == cudaSuccess) e = fix3_rows(P, Fix3Rows{in, sx, sy, out, chg}, st);
  if (e == cudaSuccess)
    e = fix3_cols(P, Fix3Cols{out, wz, wyz, P.ny}, P.nx + 2, st);
  if (e == cudaSuccess)
    e = fix3_cols(P, Fix3Cols{out, wyz, wz, P.nx}, P.ny + 2, st);
  return static_cast<int>(e);
}

// The fixed point's launches at prm's shape: out = {cells a lane of the z
// pass, cells a thread and threads a block of the y pass, the same of the x
// pass}; 0 cells where an axis is too long.
int qgd3d_smooth_fixed_shape(const QGD3DParams* prm, int* out) {
  const Fix3Shape y = fix3_col_shape(prm->ny), x = fix3_col_shape(prm->nx);
  out[0] = fix3_row_cells(prm->nz);
  out[1] = y.L;
  out[2] = y.L ? (prm->ny + y.L - 1) / y.L * y.Z : 0;
  out[3] = x.L;
  out[4] = x.L ? (prm->nx + x.L - 1) / x.L * x.Z : 0;
  return 0;
}

}  // extern "C"
