// Hand-written Hopper (sm_90a) kernels for one explicit 2D QGDFoam step.
//
// Replaces the TPU kernel qgdsolver_tpu/ops/fused_qgd2d.py::build_fused_step
// (the whole-frame Pallas kernel at :1000 running frame_fn, :540).  That
// kernel holds the whole frame in VMEM and takes a frame-wide dt before it
// updates any cell.  Blocks on a GPU cannot wait for each other, so the step
// is three launches on the caller's stream, with dt kept on the device:
//
//   qgd2d_dt      a row march over the frame: per-block max wave speed per
//                 axis and tau coefficient extremes, then the last block to
//                 finish folds them and applies setDeltaT (see its section);
//   qgd2d_update  the face fluxes, each face once, and the explicit update
//                 into NEW frames p, T, ux, uy (plus ws0/tau_f on the
//                 x-boundary faces, which the qgdFlux ghost needs);
//   qgd2d_ghosts  x-ghost rows from the fresh interior and y-ghost lanes of
//                 every row, corners included (the sequential-axis padding),
//                 each ghost from interior cells (see its section).
//
// The x-slab kernel K2 (build_tiled_fused_step, :1609) runs the same physics
// and also reads, over the fresh fields, the next step's rates and the
// varScModel5 sensor's raw value and first smoothing ring.  Here that is one
// more kernel on the fresh frames, after qgd2d_ghosts, and the rest of the
// smoothing runs on the card too:
//
//   qgd2d_emit    two-pass reduction of the Courant and tau rates, plus the
//                 raw sensor, ring 1 and the change flag (see its section);
//   qgd2d_smooth  k more fvc::smooth rings per launch on a shared-memory
//                 tile, into the sensor frame with edge-replicated ghosts,
//                 and a flag set when the last ring raised a cell.  It
//                 replaces the XLA loop the reference runs between steps
//                 (qgdsolver_tpu/physics/qgdcoeffs.py:254,
//                 fvc_smooth_continue); the host reads its flag once per
//                 launch to decide whether to launch again.
//
// The domain-decomposed step K3 (build_sharded_fused_step, :1166) runs the
// same kernels on each rank's block, whose frame edges may be partition
// edges: there the one-cell halo holds the neighbour's true cells, and the
// four edge flags of QGDParams (1: a physical boundary) tell the kernels to
// read it as it is.  At a partition edge the coefficient fields take the
// halo cell's own value instead of a zero-gradient ghost, the tau clamps of
// qgd2d_dt do not apply, no qgdFlux side row is written and no ghost is
// built (the halo exchange fills it).  The serial builders set every flag
// to 1, which is the single-block step.  dt over the ranks is a fold of
// each block's partials to one (max wave x, max wave y, -min tau) quad (the
// same launch as qgd2d_dt, qgd2d_dt_fold), a MAX all-reduce of it, then
// setDeltaT on the reduced quad (qgd2d_dt_apply): the serial path's dt bit
// for bit.
//
// Frames are contiguous (nx+2, ny+2) float32 with y the fast axis, so a warp
// reads 32 neighbouring lanes of one row.  What bounds the step on the card
// is memory: about 4 frames in and 4 out per step (plus the sensor frame for
// varScModel5), ~32-40 B per cell, but each face is ~150 float operations
// over six cells, so the update must not compute a face twice.
//
// qgd2d_update is the 2D form of qgd3d_update's x-march:
//   - a block of 64 threads owns a strip of 63 y-lanes and marches along x
//     over a chunk of rows (per launch, the longest of 32, 16, 8 and 4 rows
//     whose grid fills the card's resident blocks four times over, else 4:
//     16 at 4096x2048, 4 at 1024x512, where the grid is ~1.2 waves and
//     each block's chain of row passes bounds the time);
//   - a ring of NSLOT row slots in shared memory holds rows r-1, r, r+1,
//     each with its two halo lanes, and the row in flight, which cp.async
//     brings in while row r is computed (4-byte copies: any ny);
//   - when a row lands, each staged cell's rho and coefficients are derived
//     once, with the zero-gradient coefficient ghosts;
//   - a thread computes two faces a row, in one stretch of code the
//     compiler may interleave: the x-face r+1/2 of its lane, which it keeps
//     in registers as the next row's low face, and the y-face below its
//     lane, which goes to shared memory (the 64th thread's lane is the next
//     strip's first: its y-face closes the strip, its x-face is not used);
//   - the march starts one row before the chunk, and that pass computes only
//     the first x-face, so each face kind comes from one code site and its
//     bits do not depend on where a chunk or a block starts: K3's update on
//     a block is the serial update's window bit for bit.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "nan_fold.cuh"
#include "smooth_ring.cuh"

namespace {

enum { BC_ZG = 0, BC_FIXED = 1, BC_GRAD = 2, BC_SYM = 3, BC_EXTRAP = 4,
       BC_IO = 5, BC_QGDFLUX = 6 };

constexpr int BX = 32;   // threads along y (lanes)
constexpr int BY = 8;    // threads along x (rows)
constexpr int RED = 256; // threads of the final emit reduction

// qgd2d_update's strip and row ring
constexpr int UT = 64;               // threads of an update block
constexpr int UL = UT - 1;           // lanes of its strip
constexpr int UW = UT + 2;           // a staged row: the strip, its two halo
                                     // lanes and the lane past them
constexpr int NSLOT = 4;             // rows r-1, r, r+1 and the one in flight
// the fields of a ring slot: the frames' values, then what derive computes
enum { S_P, S_T, S_UX, S_UY, S_SC, S_RHO, S_MU, S_AU, S_TC, S_NF };
constexpr int SLOT = S_NF * UW;
constexpr int UYF = UL + 1;          // the y-faces of one row's strip: one
                                     // per thread

}  // namespace

// One ghost spec: kind, scalar value (the sign for symmetry), index of an
// array profile (-1: none).  Mirrored by ops/_build.py::BCEntry.
struct BCEntry {
  int kind;
  float value;
  int prof;
};

// Step constants, passed by value.  Mirrored by ops/_build.py::QGDParams.
struct QGDParams {
  int nx, ny, varsc, mu_const0, adjust_dt, prof_len;
  // 1 where the frame edge is a physical boundary, 0 at a partition edge
  int edge_lo, edge_hi, edge_lo_y, edge_hi_y;
  float dx, dy, inv_dx, inv_dy, inv_2dx, inv_2dy, hfx, hfy, inv_vol;
  float R, Cv, inv_Cv, CvR, gammaR, gamma, alpha, k_mu, k_muv;
  float Pr_tau, inv_Pr_tau, Pr_th, mu0;
  float max_co, max_dt, c_tau;
  // qgd2d_emit: rates per unit dt, and the varScModel5 sensor constants
  float inv_hfx, inv_hfy, h_cell, rC, one_m_rC, minSc, maxSc, cqSc,
      smooth_ratio;
  BCEntry bc[4][2][2];  // [field p, T, ux, uy][axis][side]
};

namespace {

struct Cell {
  float p, T, ux, uy, rho, e;
};

struct Coef {
  float mu;  // mu_eff
  float au;  // alphau_eff (unused when the molecular mu is 0)
  float tc;  // tau coefficient: alpha/c (constScPrModel1) or c (varScModel5)
};

struct Flux {
  float rho, m0, m1, E, ws, tau;
};

// Coefficient fields of one cell; c = gRT * rsqrt(gRT) (one rsqrt feeds c,
// alpha/c and mu).
__device__ __forceinline__ Coef cell_coef(const QGDParams& P, float p,
                                          float T, float sc) {
  const float gRT = P.gammaR * T;
  const float rcs = rsqrtf(gRT);
  Coef k;
  k.tc = P.varsc ? gRT * rcs : P.alpha * rcs;
  const float mu = P.varsc ? sc * ((P.k_muv * p) * rcs) : (P.k_mu * p) * rcs;
  if (P.mu_const0) {
    k.mu = mu;
    k.au = 0.0f;
  } else {
    k.au = mu / P.Pr_tau + P.mu0 / P.Pr_th;
    k.mu = mu + P.mu0;
  }
  return k;
}

__device__ __forceinline__ float xi(float a, float b) { return 0.5f * (a + b); }

__device__ __forceinline__ float enth(const QGDParams& P, const Cell& c) {
  return P.CvR * c.T + 0.5f * (c.ux * c.ux + c.uy * c.uy);
}

__device__ __forceinline__ float face_tau(const QGDParams& P, float ta,
                                          float tb, float h) {
  return P.varsc ? (P.alpha / xi(ta, tb)) * h : xi(ta, tb) * h;
}

// Face between A (row r) and B (row r+1) at one lane; Am/Ap and Bm/Bp are
// their lane-1/lane+1 neighbours (the tangential stencil).
__device__ Flux xface(const QGDParams& P, const Cell& A, const Cell& B,
                      const Cell& Am, const Cell& Ap, const Cell& Bm,
                      const Cell& Bp, const Coef& kA, const Coef& kB) {
  const float pf = xi(A.p, B.p);
  const float rf = xi(A.rho, B.rho);
  const float uxf = xi(A.ux, B.ux);
  const float uyf = xi(A.uy, B.uy);
  const float ruxA = A.rho * A.ux, ruxB = B.rho * B.ux;
  const float ruyA = A.rho * A.uy, ruyB = B.rho * B.uy;
  const float ruxf = xi(ruxA, ruxB);
  const float ruyf = xi(ruyA, ruyB);
  const float Hf = xi(enth(P, A), enth(P, B));
  const float muf = xi(kA.mu, kB.mu);
  const float af = P.mu_const0 ? muf * P.inv_Pr_tau : xi(kA.au, kB.au);
  const float tauf = face_tau(P, kA.tc, kB.tc, P.hfx);
  const float urr0 = xi(A.ux * ruxA, B.ux * ruxB);
  const float urr1 = xi(A.ux * ruyA, B.ux * ruyB);

  const float gU00 = (B.ux - A.ux) * P.inv_dx;
  const float gU01 = (B.uy - A.uy) * P.inv_dx;
  const float gU10 = (xi(Ap.ux, Bp.ux) - xi(Am.ux, Bm.ux)) * P.inv_2dy;
  const float gU11 = (xi(Ap.uy, Bp.uy) - xi(Am.uy, Bm.uy)) * P.inv_2dy;
  const float gRx = (B.rho - A.rho) * P.inv_dx;
  const float gRy = (xi(Ap.rho, Bp.rho) - xi(Am.rho, Bm.rho)) * P.inv_2dy;
  const float gPx = (B.p - A.p) * P.inv_dx;
  const float gPy = (xi(Ap.p, Bp.p) - xi(Am.p, Bm.p)) * P.inv_2dy;
  const float gex = (B.e - A.e) * P.inv_dx;
  const float gey = (xi(Ap.e, Bp.e) - xi(Am.e, Bm.e)) * P.inv_2dy;

  const float divU = gU00 + gU11;
  const float u_gradrho = uxf * gRx + uyf * gRy;
  const float rg0 = ruxf * gU00 + ruyf * gU10;
  const float ws0 = tauf * (u_gradrho * uxf + ruxf * divU + rg0);
  const float jm = ruxf - (ws0 + tauf * gPx);
  const float phiJm = jm * P.dy;
  const float u_gradp = uxf * gPx + uyf * gPy;
  const float iso = u_gradp + P.gamma * pf * divU;
  const float pi0 = tauf * (urr0 * gU00 + urr1 * gU10 + uxf * gPx + iso) +
                    muf * (2.0f * gU00 - (2.0f / 3.0f) * divU);
  const float pi1 = tauf * (urr0 * gU01 + urr1 * gU11 + uxf * gPy) +
                    muf * (gU01 + gU10);
  const float prr = pf / (rf * rf);
  const float de0 = gex - prr * gRx;
  const float de1 = gey - prr * gRy;
  const float q = -tauf * (urr0 * de0 + urr1 * de1) - af * gex;

  Flux f;
  f.rho = phiJm;
  f.m0 = phiJm * uxf + P.dy * (pf - pi0);
  f.m1 = phiJm * uyf - P.dy * pi1;
  f.E = phiJm * Hf + P.dy * (q - (pi0 * uxf + pi1 * uyf));
  f.ws = ws0;
  f.tau = tauf;
  return f;
}

// Face between C (lane s) and D (lane s+1) on one row; Cm/Cp and Dm/Dp are
// their row-1/row+1 neighbours.
__device__ Flux yface(const QGDParams& P, const Cell& C, const Cell& D,
                      const Cell& Cm, const Cell& Cp, const Cell& Dm,
                      const Cell& Dp, const Coef& kC, const Coef& kD) {
  const float pf = xi(C.p, D.p);
  const float rf = xi(C.rho, D.rho);
  const float uxf = xi(C.ux, D.ux);
  const float uyf = xi(C.uy, D.uy);
  const float ruxC = C.rho * C.ux, ruxD = D.rho * D.ux;
  const float ruyC = C.rho * C.uy, ruyD = D.rho * D.uy;
  const float ruxf = xi(ruxC, ruxD);
  const float ruyf = xi(ruyC, ruyD);
  const float Hf = xi(enth(P, C), enth(P, D));
  const float muf = xi(kC.mu, kD.mu);
  const float af = P.mu_const0 ? muf * P.inv_Pr_tau : xi(kC.au, kD.au);
  const float tauf = face_tau(P, kC.tc, kD.tc, P.hfy);
  const float urr0 = xi(C.uy * ruxC, D.uy * ruxD);
  const float urr1 = xi(C.uy * ruyC, D.uy * ruyD);

  const float hU10 = (D.ux - C.ux) * P.inv_dy;
  const float hU11 = (D.uy - C.uy) * P.inv_dy;
  const float hU00 = (xi(Cp.ux, Dp.ux) - xi(Cm.ux, Dm.ux)) * P.inv_2dx;
  const float hU01 = (xi(Cp.uy, Dp.uy) - xi(Cm.uy, Dm.uy)) * P.inv_2dx;
  const float hRx = (xi(Cp.rho, Dp.rho) - xi(Cm.rho, Dm.rho)) * P.inv_2dx;
  const float hRy = (D.rho - C.rho) * P.inv_dy;
  const float hPx = (xi(Cp.p, Dp.p) - xi(Cm.p, Dm.p)) * P.inv_2dx;
  const float hPy = (D.p - C.p) * P.inv_dy;
  const float hex = (xi(Cp.e, Dp.e) - xi(Cm.e, Dm.e)) * P.inv_2dx;
  const float hey = (D.e - C.e) * P.inv_dy;

  const float divU = hU00 + hU11;
  const float u_gradrho = uxf * hRx + uyf * hRy;
  const float rg1 = ruxf * hU01 + ruyf * hU11;
  const float ws1 = tauf * (u_gradrho * uyf + ruyf * divU + rg1);
  const float jm = ruyf - (ws1 + tauf * hPy);
  const float phiJm = jm * P.dx;
  const float u_gradp = uxf * hPx + uyf * hPy;
  const float iso = u_gradp + P.gamma * pf * divU;
  const float qi0 = tauf * (urr0 * hU00 + urr1 * hU10 + uyf * hPx) +
                    muf * (hU00 + hU10);
  const float qi1 = tauf * (urr0 * hU01 + urr1 * hU11 + uyf * hPy + iso) +
                    muf * (2.0f * hU11 - (2.0f / 3.0f) * divU);
  const float prr = pf / (rf * rf);
  const float he0 = hex - prr * hRx;
  const float he1 = hey - prr * hRy;
  const float q = -tauf * (urr0 * he0 + urr1 * he1) - af * hey;

  Flux f;
  f.rho = phiJm;
  f.m0 = phiJm * uxf - P.dx * qi0;
  f.m1 = phiJm * uyf + P.dx * (pf - qi1);
  f.E = phiJm * Hf + P.dx * (q - (qi0 * uxf + qi1 * uyf));
  f.ws = ws1;
  f.tau = tauf;
  return f;
}

__device__ __forceinline__ float wave(const QGDParams& P, float uA, float uB,
                                      float TA, float TB) {
  const float gA = P.gammaR * TA, gB = P.gammaR * TB;
  return fabsf(xi(uA, uB)) + xi(gA * rsqrtf(gA), gB * rsqrtf(gB));
}

// ---------------------------------------------------------------------------
// qgd2d_dt: the acoustic Courant number and min tau_f, then setDeltaT
// ---------------------------------------------------------------------------
//
// Replaces the Courant and tau pre-pass of the TPU kernel's frame_fn
// (qgdsolver_tpu/ops/fused_qgd2d.py:736-768): over the live faces of each
// axis, the max acoustic wave |u_f| + c_f and the min tau_f with
// zero-gradient coefficient ghosts at physical boundaries, then setDeltaT.
// It reads three frames once (T, ux, uy) and does ~10 operations a cell,
// so bytes and latency bound it: a call is one launch.
//
// A warp owns 31 consecutive frame lanes of a chunk of 4 rows and loads a
// 32nd, the next warp's first lane, beside them: every face a warp owns
// takes both its cells from the warp, so no halo crosses warps and no
// thread computes a cell alone (1/32 of the loads are repeated).  Each
// thread loads its lane's T, ux and uy of the chunk's rows and of the row
// before it, all issued before any face is computed, and computes each
// cell's g = gammaR*T, r = rsqrt(g), c = RN(g*r) and tau coefficient once;
// the x-face takes the row before from registers, the y-face the next
// lane by warp shuffle.  The tau coefficient of a face is folded per axis
// (max c_f for varScModel5, min (alpha*rsqrt(g))_f otherwise) and divided
// or scaled once per axis at the end: RN(alpha/x) and RN(x*h) are
// monotone, so the min over faces of tau_f is the same float.  Each block
// writes its partial (one float4) and the last block to finish (a ticket
// in the workspace, which that block sets back to 0) folds them and
// applies setDeltaT (DT_FULL) or writes the quad (DT_FOLD); unrolling that
// fold cost the K3 block's call 1 us (PERF.md).  The face formulas write
// out nvcc's contraction of the face expressions (c_A + c_B as fma(g_A,
// rsqrt(g_A), c_B), and the constScPr coefficients likewise as fma(alpha,
// rsqrt(g_A), RN(alpha*rsqrt(g_B)))), and max and min are exact in any
// order, so the chunk and the fold order do not move a bit.

constexpr int DT_WARPS = 8;             // warps of a dt block
constexpr int DT_NT = 32 * DT_WARPS;    // threads of a dt block
constexpr int DT_OWN = 31;              // lanes a warp owns
constexpr int DT_CX = 4;                // rows a warp takes: chunks of 8
                                        // took 1.07x the time at 1024x512
                                        // and 1.15x on K3's 512x256 block
constexpr int DT_NQ = 4;                // a partial: 2 max waves, 2 tau
                                        // coefficient extremes
constexpr int DT_HEAD = 4;              // the workspace's ticket, padded

enum { DT_FULL = 0, DT_FOLD = 1 };

// What a face needs of its cell: the velocity along the face's axis, g =
// gammaR*T, r = rsqrt(g), c = RN(g*r) and the tau coefficient tc (c, or
// RN(alpha*r) under constScPrModel1).
struct DtCell {
  float u, g, r, c, tc;
};

__device__ __forceinline__ DtCell dt_cell(const QGDParams& P, float T,
                                          float u) {
  DtCell k;
  k.u = u;
  k.g = __fmul_rn(P.gammaR, T);
  k.r = rsqrtf(k.g);
  k.c = __fmul_rn(k.g, k.r);
  k.tc = P.varsc ? k.c : __fmul_rn(P.alpha, k.r);
  return k;
}

// |u_f| + c_f of the face between A (low) and B (high).
__device__ __forceinline__ float dt_wave(const DtCell& A, float uB,
                                         float cB) {
  return __fadd_rn(fabsf(__fmul_rn(0.5f, __fadd_rn(A.u, uB))),
                   __fmul_rn(0.5f, __fmaf_rn(A.g, A.r, cB)));
}

// The tau coefficient of the face between A and B (its two clamped cells):
// xi(tc_A, tc_B), tc_A's product fused into the sum.
__device__ __forceinline__ float dt_coef(const QGDParams& P, const DtCell& A,
                                         float tcB) {
  return __fmul_rn(0.5f, __fmaf_rn(P.varsc ? A.g : P.alpha, A.r, tcB));
}

// The fold of one partial entry: waves (a < 2) and varScModel5's c_f take
// the max, constScPrModel1's coefficient the min.
__device__ __forceinline__ float dt_fold(float v, float w, int a, bool vs) {
  return a < 2 || vs ? nan_max(v, w) : nan_min(v, w);
}

// v over the block (warp shuffles, one slot a warp, one barrier); thread
// 0 holds the result.
__device__ __forceinline__ void dt_fold_block(float (&v)[DT_NQ], bool vs,
                                              float (*slots)[DT_WARPS]) {
  const int tid = threadIdx.x;
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
      for (int w = 1; w < DT_WARPS; ++w)
        v[a] = dt_fold(v[a], slots[a][w], a, vs);
  }
}

// setDeltaT (immediate reduction, damped increase, cTau*min(tau_f) and
// maxDeltaT caps) with explicit roundings: no FMA contraction.
__device__ __forceinline__ float set_delta_t(const QGDParams& P, float mx,
                                             float my, float tmin,
                                             float dtv) {
  if (!P.adjust_dt) return dtv;
  const float co = nan_max(__fdiv_rn(__fmul_rn(mx, dtv), P.hfx),
                           __fdiv_rn(__fmul_rn(my, dtv), P.hfy));
  const float max_fact = __fdiv_rn(P.max_co, __fadd_rn(co, 1e-30f));
  const float fact = nan_min(
      nan_min(max_fact, __fadd_rn(1.0f, __fmul_rn(0.1f, max_fact))), 1.2f);
  const float max_dt1 = nan_min(P.max_dt, __fmul_rn(P.c_tau, tmin));
  return nan_min(__fmul_rn(fact, dtv), max_dt1);
}

// Warp g = DT_WARPS*blockIdx.x + warp of a block takes strip g % strips and
// chunk g / strips: the frame lanes s = DT_OWN*strip + lane and the rows
// q = DT_CX*chunk .. DT_CX*(chunk + 1) - 1 (up to nx+1), after loading the
// row before them.  Row q's pass computes, for the lanes the warp owns (lane <
// DT_OWN, s <= ny), the x-face q-1/2 (q >= 1, s >= 1) and, for 1 <= q <=
// nx, the y-face s+1/2: exactly the live face sets of the reference's
// pre-pass, each once.  The zero-gradient tau coefficient ghosts make a
// physical boundary face's coefficient that of its interior cell alone
// (xi of the cell with itself); the y-face 1/2's is taken by lane 1's
// thread beside its own face.
__global__ void __launch_bounds__(DT_NT)
qgd2d_dt_kernel(QGDParams P, const float* __restrict__ T,
                const float* __restrict__ ux, const float* __restrict__ uy,
                int strips, int mode, const float* __restrict__ dt_old,
                float* __restrict__ work, float* __restrict__ out) {
  __shared__ float slots[DT_NQ][DT_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int nx = P.nx, ny = P.ny, W = ny + 2;
  const bool vs = P.varsc != 0;
  const int g = blockIdx.x * DT_WARPS + (threadIdx.x >> 5);
  const int chunk = g / strips;
  const int s = (g - chunk * strips) * DT_OWN + lane;
  const int r0 = chunk * DT_CX;
  const bool own = lane < DT_OWN && s <= ny;  // owns the y-face s+1/2
  const bool xo = own && s >= 1;              // and the x-faces at lane s

  // every load first: slot i holds row r0 - 1 + i (the row before the
  // chunk only gives x-faces: no uy)
  float Tv[DT_CX + 1], uxv[DT_CX + 1], uyv[DT_CX + 1];
#pragma unroll
  for (int i = 0; i <= DT_CX; ++i) {
    const int q = r0 - 1 + i;
    const bool in = s <= ny + 1 && q >= 0 && q <= nx + 1;
    const long a = (long)q * W + s;
    Tv[i] = in ? T[a] : 1.0f;
    uxv[i] = in ? ux[a] : 1.0f;
    uyv[i] = in && i > 0 ? uy[a] : 1.0f;
  }

  const float kid = vs ? -INFINITY : INFINITY;
  float v[DT_NQ] = {-INFINITY, -INFINITY, kid, kid};
  DtCell prev = dt_cell(P, Tv[0], uxv[0]);
#pragma unroll
  for (int i = 1; i <= DT_CX; ++i) {
    const int q = r0 - 1 + i;
    if (q > nx + 1) break;  // uniform in the warp
    const DtCell o = dt_cell(P, Tv[i], uxv[i]);
    if (q >= 1 && xo) {
      // x-face q-1/2; coefficient ghosts zero-gradient at physical x ends
      v[0] = nan_max(v[0], dt_wave(prev, o.u, o.c));
      const float k = q == 1 && P.edge_lo        ? dt_coef(P, o, o.tc)
                      : q == nx + 1 && P.edge_hi ? dt_coef(P, prev, prev.tc)
                                                 : dt_coef(P, prev, o.tc);
      v[2] = dt_fold(v[2], k, 2, vs);
    }
    if (q >= 1 && q <= nx) {  // uniform in the warp
      // the y neighbour s+1: the next lane's cell
      const float nc = __shfl_down_sync(0xffffffffu, o.c, 1);
      const float ntc = __shfl_down_sync(0xffffffffu, o.tc, 1);
      const float nu = __shfl_down_sync(0xffffffffu, uyv[i], 1);
      if (own) {
        DtCell oy = o;
        oy.u = uyv[i];
        v[1] = nan_max(v[1], dt_wave(oy, nu, nc));
        if (!(s == 0 && P.edge_lo_y)) {
          const float k = s == ny && P.edge_hi_y ? dt_coef(P, o, o.tc)
                                                 : dt_coef(P, o, ntc);
          v[3] = dt_fold(v[3], k, 3, vs);
        }
        if (s == 1 && P.edge_lo_y)
          v[3] = dt_fold(v[3], dt_coef(P, o, o.tc), 3, vs);
      }
    }
    prev = o;
  }

  dt_fold_block(v, vs, slots);
  const unsigned nb = gridDim.x;
  unsigned* ticket = reinterpret_cast<unsigned*>(work);
  float4* parts = reinterpret_cast<float4*>(work + DT_HEAD);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
    __threadfence();
    last = atomicAdd(ticket, 1u) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every block's partial (from L2), then the result
  v[0] = v[1] = -INFINITY;
  v[2] = v[3] = kid;
  for (unsigned i = threadIdx.x; i < nb; i += DT_NT) {
    const float4 w = __ldcg(parts + i);
    v[0] = nan_max(v[0], w.x);
    v[1] = nan_max(v[1], w.y);
    v[2] = dt_fold(v[2], w.z, 2, vs);
    v[3] = dt_fold(v[3], w.w, 3, vs);
  }
  dt_fold_block(v, vs, slots);
  if (threadIdx.x != 0) return;
  *ticket = 0u;  // the next launch on this workspace starts from 0
  const float tmin =
      vs ? nan_min(__fmul_rn(__fdiv_rn(P.alpha, v[2]), P.hfx),
                   __fmul_rn(__fdiv_rn(P.alpha, v[3]), P.hfy))
         : nan_min(__fmul_rn(v[2], P.hfx), __fmul_rn(v[3], P.hfy));
  if (mode == DT_FOLD) {
    out[0] = v[0];
    out[1] = v[1];
    out[2] = -tmin;
    out[3] = 0.0f;
    return;
  }
  out[0] = set_delta_t(P, v[0], v[1], tmin, dt_old[0]);
}

// setDeltaT on one reduced quad of qgd2d_dt_fold (max wave x, max wave y,
// -min tau, 0): one thread.
__global__ void qgd2d_dt_apply_kernel(QGDParams P,
                                      const float* __restrict__ quad,
                                      const float* __restrict__ dt_old,
                                      float* __restrict__ out) {
  out[0] = set_delta_t(P, quad[0], quad[1], -quad[2], dt_old[0]);
}

// The x-march (see the note at the top).  Block (bx, bz) owns the lanes
// s0 = 1 + UL*bx .. s0+UL-1 of the rows r0 = 1 + cx*bz .. re; thread t
// computes the faces of lane s0 + t and, for t < UL, updates it.  Staged
// lane i of a slot is frame lane s0 - 1 + i; staged lanes beyond the frame
// repeat its last one, so every staged value is finite, and no live cell
// reads them.

// Staged cell i of ring slot S: the frame values and the derived rho.
__device__ __forceinline__ Cell slot_cell(const QGDParams& P, const float* S,
                                          int i) {
  Cell c;
  c.p = S[S_P * UW + i];
  c.T = S[S_T * UW + i];
  c.ux = S[S_UX * UW + i];
  c.uy = S[S_UY * UW + i];
  c.rho = S[S_RHO * UW + i];
  c.e = P.Cv * c.T;
  return c;
}

__device__ __forceinline__ Coef slot_coef(const float* S, int i) {
  Coef k;
  k.mu = S[S_MU * UW + i];
  k.au = S[S_AU * UW + i];
  k.tc = S[S_TC * UW + i];
  return k;
}

__global__ void __launch_bounds__(UT, 8)
qgd2d_update_kernel(QGDParams P, const float* __restrict__ p,
                    const float* __restrict__ T, const float* __restrict__ ux,
                    const float* __restrict__ uy, const float* __restrict__ sc,
                    const float* __restrict__ dt, float* __restrict__ pn,
                    float* __restrict__ Tn, float* __restrict__ uxn,
                    float* __restrict__ uyn, float* __restrict__ side,
                    int cx) {
  __shared__ float ring[NSLOT * SLOT];
  __shared__ float yfl[4 * UYF];  // rho, m0, m1, E of the strip's y-faces
  const int tid = threadIdx.x;
  const int nx = P.nx, ny = P.ny, W = ny + 2;
  const int s0 = 1 + blockIdx.x * UL;
  const int r0 = 1 + blockIdx.y * cx;
  const int re = r0 + cx - 1 < nx ? r0 + cx - 1 : nx;

  auto slot = [&](int q) { return ring + (q & (NSLOT - 1)) * SLOT; };
  auto lane_of = [&](int i) {
    const int s = s0 - 1 + i;
    return s > ny + 1 ? ny + 1 : s;
  };
  // row q's frame values into its slot, by cp.async; this thread copies the
  // staged lanes tid, tid + UT
  auto stage = [&](int q) {
    float* S = slot(q);
    for (int i = tid; i < UW; i += UT) {
      const long g = (long)q * W + lane_of(i);
      __pipeline_memcpy_async(S + S_P * UW + i, p + g, sizeof(float));
      __pipeline_memcpy_async(S + S_T * UW + i, T + g, sizeof(float));
      __pipeline_memcpy_async(S + S_UX * UW + i, ux + g, sizeof(float));
      __pipeline_memcpy_async(S + S_UY * UW + i, uy + g, sizeof(float));
      if (P.varsc)
        __pipeline_memcpy_async(S + S_SC * UW + i, sc + g, sizeof(float));
    }
  };
  // rho and the coefficient fields of row q's staged cells: the cells this
  // thread staged, so its own wait for the copies suffices.  The
  // coefficients take zero-gradient ghosts at physical edges: a ghost lane
  // and a ghost row take the value of the interior cell beside them (read
  // from the frame); a halo across a partition edge keeps its own.
  auto derive = [&](int q) {
    float* S = slot(q);
    const int rc =
        q == 0 && P.edge_lo ? 1 : (q == nx + 1 && P.edge_hi ? nx : q);
    for (int i = tid; i < UW; i += UT) {
      const int s = lane_of(i);
      const float pv = S[S_P * UW + i], Tv = S[S_T * UW + i];
      S[S_RHO * UW + i] = pv / (P.R * Tv);
      const int cs =
          s == 0 && P.edge_lo_y ? 1 : (s == ny + 1 && P.edge_hi_y ? ny : s);
      float cp = pv, cT = Tv, csc = P.varsc ? S[S_SC * UW + i] : 0.0f;
      if (rc != q || cs != s) {
        const long g = (long)rc * W + cs;
        cp = p[g];
        cT = T[g];
        csc = P.varsc ? sc[g] : 0.0f;
      }
      const Coef k = cell_coef(P, cp, cT, csc);
      S[S_MU * UW + i] = k.mu;
      S[S_AU * UW + i] = k.au;
      S[S_TC * UW + i] = k.tc;
    }
  };

  const int s = s0 + tid;
  const bool live = tid < UL && s <= ny;
  const int ic = tid + 1;  // this thread's lane in a slot
  const float sdt = dt[0] * P.inv_vol;
  Flux xlo = {}, hi = {};

  stage(r0 - 1);
  __pipeline_commit();
  stage(r0);
  __pipeline_commit();
  // pass r computes the x-face r+1/2 and, from r0 on, updates row r; the
  // pass r0 - 1 only gives the chunk's first x-face
#pragma unroll 1
  for (int r = r0 - 1; r <= re; ++r) {
    // row r+2 goes to the slot of row r-2, which no thread reads since the
    // last barrier
    if (r + 2 <= re + 1) stage(r + 2);
    __pipeline_commit();          // a group per pass, empty at the end
    __pipeline_wait_prior(1);     // this thread's copies of row r+1
#pragma unroll 1
    for (int q = r == r0 - 1 ? r : r + 1; q <= r + 1; ++q) derive(q);
    __syncthreads();  // row r+1 complete; the last pass's faces read
    const float* S0 = slot(r);
    const float* Sp = slot(r + 1);
    hi = xface(P, slot_cell(P, S0, ic), slot_cell(P, Sp, ic),
               slot_cell(P, S0, ic - 1), slot_cell(P, S0, ic + 1),
               slot_cell(P, Sp, ic - 1), slot_cell(P, Sp, ic + 1),
               slot_coef(S0, ic), slot_coef(Sp, ic));
    // ws0/tau_f on the physical x-boundary faces: the qgdFlux p ghost of
    // this step
    if (live && r == 0 && P.edge_lo) side[s] = hi.ws / hi.tau;
    if (live && r == nx && P.edge_hi) side[W + s] = hi.ws / hi.tau;
    if (r >= r0) {
      const float* Sm = slot(r - 1);
      const Flux yf = yface(P, slot_cell(P, S0, tid), slot_cell(P, S0, ic),
                            slot_cell(P, Sm, tid), slot_cell(P, Sp, tid),
                            slot_cell(P, Sm, ic), slot_cell(P, Sp, ic),
                            slot_coef(S0, tid), slot_coef(S0, ic));
      yfl[0 * UYF + tid] = yf.rho;
      yfl[1 * UYF + tid] = yf.m0;
      yfl[2 * UYF + tid] = yf.m1;
      yfl[3 * UYF + tid] = yf.E;
    }
    __syncthreads();  // the y-faces of row r
    if (r >= r0 && live) {
      const Cell o = slot_cell(P, S0, ic);
      const float* yl = yfl + tid;
      const float* yh = yfl + tid + 1;
      const float rho = o.rho;
      const float rux = rho * o.ux, ruy = rho * o.uy;
      const float ke = o.ux * o.ux + o.uy * o.uy;
      const float rhoE = rho * (o.e + 0.5f * ke);
      const float rhon =
          rho - sdt * ((hi.rho - xlo.rho) + (yh[0] - yl[0]));
      const float rux_n =
          rux - sdt * ((hi.m0 - xlo.m0) + (yh[UYF] - yl[UYF]));
      const float ruy_n =
          ruy - sdt * ((hi.m1 - xlo.m1) + (yh[2 * UYF] - yl[2 * UYF]));
      const float rhoEn =
          rhoE - sdt * ((hi.E - xlo.E) + (yh[3 * UYF] - yl[3 * UYF]));
      const float inv_rhon = 1.0f / rhon;
      const float uxv = rux_n * inv_rhon;
      const float uyv = ruy_n * inv_rhon;
      const float en = rhoEn * inv_rhon - 0.5f * (uxv * uxv + uyv * uyv);
      const float Tv = en * P.inv_Cv;
      const long i0 = (long)r * W + s;
      pn[i0] = rhon * P.R * Tv;
      Tn[i0] = Tv;
      uxn[i0] = uxv;
      uyn[i0] = uyv;
    }
    xlo = hi;
  }
}

// ---------------------------------------------------------------------------
// qgd2d_ghosts: every BC ghost of the four fresh frames in one launch
// ---------------------------------------------------------------------------
//
// The semantics are the sequential-axis padding of the reference kernel
// (qgdsolver_tpu/ops/fused_qgd2d.py:789-856) and of ghosts_reference:
// x-ghost rows from the fresh interior (qgdFlux p from `side`, array values
// from the profile table), then y-ghost lanes of every row, so a corner
// takes the x-ghosts beside it; inletOutlet switches on the nearest
// interior cell's outward velocity; a partition side is left to the halo
// exchange (at a partition x-edge the lane ghosts of the halo row are
// computed from it as it stands, and the row exchange overwrites them).
// Blocks never wait for each other, so each ghost cell is computed from
// interior cells alone: a corner is the y-formula of the two x-ghosts at
// lanes l1 and l2 of its row, which its thread computes itself, and no
// ghost that the launch writes is read.  A thread owns one ghost cell of
// one field: consecutive threads take consecutive lanes of an x-ghost row,
// which is written whole, and the two ends of a row.  An extrapolated
// ghost reads the second interior layer: along an axis of one cell whose
// two ends are physical that layer is a ghost this launch writes, and
// supported() refuses the config.

constexpr int GT = 256;  // threads of a ghost block

__device__ __forceinline__ float bc_ghost(const BCEntry& b, float in1,
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

struct Ghosts2 {
  const float* __restrict__ prof;  // (n, prof_len) array BC values
  const float* __restrict__ side;  // (2, ny+2) ws/tau_f of the x ends
  float* f[4];                     // p, T, ux, uy
};

// The frame of field F (a constant: no frame table goes to the stack).
template <int F>
__device__ __forceinline__ float* field_of(const Ghosts2& G) {
  return F == 0 ? G.f[0] : F == 1 ? G.f[1] : F == 2 ? G.f[2] : G.f[3];
}

// One side's BC entry of field F along axis a: sd is not a constant here,
// and indexing the params with it would copy them to local memory.
template <int F>
__device__ __forceinline__ BCEntry bc_at(const QGDParams& P, int a, int sd) {
  return sd == 0 ? P.bc[F][a][0] : P.bc[F][a][1];
}

// Field F at frame cell (r, s) after the x phase: on a physical x-edge's
// ghost row its x-ghost, from the interior rows; else the frame's own value
// (interior, or a partition's halo row).
template <int F>
__device__ __forceinline__ float x_value(const QGDParams& P,
                                         const Ghosts2& G, int r, int s) {
  const int nx = P.nx, W = P.ny + 2;
  const float* fld = field_of<F>(G);
  const bool lo = r == 0 && P.edge_lo;
  if (!lo && !(r == nx + 1 && P.edge_hi)) return fld[(long)r * W + s];
  const int sd = lo ? 0 : 1;
  const long r1 = lo ? 1 : nx, r2 = lo ? 2 : nx - 1;
  const BCEntry b = bc_at<F>(P, 0, sd);
  const float in1 = fld[r1 * W + s], in2 = fld[r2 * W + s];
  const float un = G.f[2][r1 * W + s];
  const float pv = G.prof[(b.prof > 0 ? b.prof : 0) * P.prof_len + s];
  const float q = G.side[sd * W + s];
  if (b.kind == BC_QGDFLUX)
    return sd == 0 ? __fmaf_rn(q, P.dx, in1) : __fmaf_rn(-q, P.dx, in1);
  return bc_ghost(b, in1, in2, P.dx, b.prof >= 0 ? pv : b.value, un, sd);
}

// Field F's y-ghost on side sd of row r: the y-formula of two values after
// the x phase.
template <int F>
__device__ __forceinline__ float y_ghost(const QGDParams& P,
                                         const Ghosts2& G, int r, int sd) {
  const int nx = P.nx, ny = P.ny, W = ny + 2;
  const int l1 = sd == 0 ? 1 : ny, l2 = sd == 0 ? 2 : ny - 1;
  const float* fld = field_of<F>(G);
  // inletOutlet on the ghost rows switches on the edge interior row
  const float un = G.f[3][(long)(r < 1 ? 1 : (r > nx ? nx : r)) * W + l1];
  const BCEntry e = bc_at<F>(P, 1, sd);
  const float pv = G.prof[(e.prof > 0 ? e.prof : 0) * P.prof_len + r];
  // on a physical x-ghost row the x phase wrote lanes 1..ny (l2 is a ghost
  // lane when ny is 1: only an extrapolated ghost reads it)
  const bool xrow = (r == 0 && P.edge_lo) || (r == nx + 1 && P.edge_hi);
  const float a = xrow ? x_value<F>(P, G, r, l1) : fld[(long)r * W + l1];
  const float b = xrow && l2 >= 1 && l2 <= ny ? x_value<F>(P, G, r, l2)
                                               : fld[(long)r * W + l2];
  return bc_ghost(e, a, b, P.dy, e.prof >= 0 ? pv : e.value, un, sd);
}

// Thread k of field F's ghost cells: the x-ghosts (sd, s), then the
// y-ghosts (r, sd), the last index fastest.  A partition side's threads
// return: the exchange fills it.
template <int F>
__device__ __forceinline__ void ghost_cell(const QGDParams& P,
                                           const Ghosts2& G, long k) {
  const int nx = P.nx, ny = P.ny, W = ny + 2;
  float* fld = field_of<F>(G);
  if (k < 2L * ny) {
    const int sd = k < ny ? 0 : 1;
    if (!(sd == 0 ? P.edge_lo : P.edge_hi)) return;
    const int s = 1 + (int)(k - (long)sd * ny);
    const int r = sd == 0 ? 0 : nx + 1;
    fld[(long)r * W + s] = x_value<F>(P, G, r, s);
    return;
  }
  k -= 2L * ny;
  if (k >= 2L * (nx + 2)) return;
  const int r = (int)(k >> 1), sd = (int)(k & 1);
  if (!(sd == 0 ? P.edge_lo_y : P.edge_hi_y)) return;
  fld[(long)r * W + (sd == 0 ? 0 : ny + 1)] = y_ghost<F>(P, G, r, sd);
}

__global__ void __launch_bounds__(GT)
qgd2d_ghosts_kernel(QGDParams P, Ghosts2 G) {
  const long k = (long)blockIdx.x * GT + threadIdx.x;
  switch (blockIdx.y) {
    case 0: ghost_cell<0>(P, G, k); break;
    case 1: ghost_cell<1>(P, G, k); break;
    case 2: ghost_cell<2>(P, G, k); break;
    default: ghost_cell<3>(P, G, k);
  }
}

// ---------------------------------------------------------------------------
// qgd2d_emit: what the next step needs, read from the fresh frames
// ---------------------------------------------------------------------------
//
// Replaces the epilogue of the TPU slab kernel K2
// (qgdsolver_tpu/ops/fused_qgd2d.py::build_tiled_fused_step, kernel :1609;
// emit_dt/emit_sc in frame_fn :863-994): the next step's Courant and tau
// rates and, for varScModel5, the raw sensor, its first fvc::smooth ring and
// the change flag.  It runs after qgd2d_ghosts: the rates read the fresh
// ghost rows and lanes, which qgd2d_update has not written yet.
//
// Bounded by memory like the update: one pass over p, T, ux, uy and sc
// (~20 B/cell in, 8 B/cell out).  Ring 1 at a block edge needs raw values of
// the neighbouring block's cells; rather than reading them back (a second
// launch) or repairing them afterwards (the reference's strip fixes), each
// block stages rho over its ETR x ETL tile plus two rings (1.2x the tile's
// cells) and sc over the tile plus one ring in shared memory, computes raw
// over tile + 1, then ring 1 over the tile.  Each thread owns 8 cells of the
// tile.  The block's five partials fold by warp shuffles, one slot per warp
// and one barrier.  The sensor's arithmetic uses explicit roundings (no FMA
// contraction), so raw, ring 1 and the flag are those of the plain torch
// version bit for bit; the rates use rsqrtf like qgd2d_dt.

constexpr int EMIT_NP = 8;      // floats per block partial (5 used)
constexpr int ETR = 32;         // tile rows of an emit block (4 per thread)
constexpr int ETL = 64;         // tile lanes (2 per thread)
constexpr int ER = ETR + 4;     // staged rho rows: the tile and two rings
constexpr int EL = ETL + 4;     // staged rho lanes
constexpr int SR = ETR + 2;     // raw sensor rows: the tile and one ring
constexpr int SL = ETL + 2;     // raw sensor lanes
constexpr int NWARP = BX * BY / 32;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The tau coefficient of a cell: c (varScModel5) or alpha/c.
__device__ __forceinline__ float tau_coef(const QGDParams& P, float T) {
  const float gRT = P.gammaR * T;
  const float rcs = rsqrtf(gRT);
  return P.varsc ? gRT * rcs : P.alpha * rcs;
}

// The raw varScModel5 sensor of the cell at R[i][j] (rho with zero-gradient
// ghosts staged around it): clip(rC*|grad rho|*h/rho + (1-rC)*sc, minSc,
// maxSc), floored at cqSc; the cell gradient is the Gauss one of the
// linear face interpolates.  The clamps propagate NaN, as torch.clamp does.
__device__ __forceinline__ float raw_sensor(const QGDParams& P,
                                            const float (*R)[EL], int i,
                                            int j, float scv) {
  const float h = 0.5f;
  const float fa_lo = __fadd_rn(__fmul_rn(h, R[i - 1][j]), __fmul_rn(h, R[i][j]));
  const float fa_hi = __fadd_rn(__fmul_rn(h, R[i][j]), __fmul_rn(h, R[i + 1][j]));
  const float fb_lo = __fadd_rn(__fmul_rn(h, R[i][j - 1]), __fmul_rn(h, R[i][j]));
  const float fb_hi = __fadd_rn(__fmul_rn(h, R[i][j]), __fmul_rn(h, R[i][j + 1]));
  const float gx = __fdiv_rn(__fadd_rn(fa_hi, -fa_lo), P.dx);
  const float gy = __fdiv_rn(__fadd_rn(fb_hi, -fb_lo), P.dy);
  const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  const float v = __fadd_rn(
      __fmul_rn(P.rC, __fdiv_rn(__fmul_rn(mag, P.h_cell), R[i][j])),
      __fmul_rn(P.one_m_rC, scv));
  return nan_max(nan_min(nan_max(v, P.minSc), P.maxSc), P.cqSc);
}

// Fold the emit partials v[0..4] (wave x, wave y, tau coefficient x and y,
// flag) over the block: maxima, except the tau coefficient folds under
// constScPr, which are minima.  Warp shuffles, one slot per warp, one
// barrier; thread 0 holds the result.
template <int NW>
__device__ __forceinline__ void fold_emit(float v[5], bool vs,
                                          float (*slots)[NW]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const bool mx = (q == 2 || q == 3) ? vs : true;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[q], o);
      v[q] = mx ? nan_max(v[q], u) : nan_min(v[q], u);
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) slots[q][tid >> 5] = v[q];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const bool mx = (q == 2 || q == 3) ? vs : true;
      for (int w = 1; w < NW; ++w)
        v[q] = mx ? nan_max(v[q], slots[q][w]) : nan_min(v[q], slots[q][w]);
    }
  }
}

// Pass 1: thread (tx, ty) of block (bx, by) owns the frame cells (r, s) =
// (ETR*by + ty + BY*m, ETL*bx + tx + BX*n), m < 4, n < 2.  For r in 0..nx,
// s in 0..ny it owns the x-face r+1/2 at lane s (s >= 1), the y-face s+1/2
// at row r (r >= 1) — the live face sets of qgd2d_dt — and, for
// varScModel5, the sensor of cell (r, s) when it is an interior cell.
// Per-block partials: max wave x, max wave y, the tau coefficient face
// extreme per axis (max c_f, or min (alpha/c)_f), the flag.
__global__ void __launch_bounds__(BX * BY)
qgd2d_emit_partial_kernel(QGDParams P, const float* __restrict__ p,
                          const float* __restrict__ T,
                          const float* __restrict__ ux,
                          const float* __restrict__ uy,
                          const float* __restrict__ sc,
                          float* __restrict__ partials,
                          float* __restrict__ sc_raw,
                          float* __restrict__ sc_s1) {
  __shared__ float slots[5][NWARP];
  __shared__ float rho_t[ER][EL];
  __shared__ float sc_t[SR][SL];
  __shared__ float raw_t[SR][SL];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const int s0 = blockIdx.x * ETL, r0 = blockIdx.y * ETR;
  const int nx = P.nx, ny = P.ny, W = ny + 2;
  const bool vs = P.varsc != 0;
  const float c_id = vs ? -INFINITY : INFINITY;  // identity of the tau fold
  float v[5] = {-INFINITY, -INFINITY, c_id, c_id, 0.0f};
#pragma unroll
  for (int m = 0; m < ETR / BY; ++m) {
#pragma unroll
    for (int n = 0; n < ETL / BX; ++n) {
      const int r = r0 + ty + BY * m, s = s0 + tx + BX * n;
      if (r > nx || s > ny) continue;
      if (s >= 1) {
        const int a = r * W + s, b = a + W;
        v[0] = nan_max(v[0], wave(P, ux[a], ux[b], T[a], T[b]));
        // coefficient ghosts are zero-gradient: clamp to the interior rows
        const float cx = xi(tau_coef(P, T[clampi(r, 1, nx) * W + s]),
                            tau_coef(P, T[clampi(r + 1, 1, nx) * W + s]));
        v[2] = vs ? nan_max(v[2], cx) : nan_min(v[2], cx);
      }
      if (r >= 1) {
        const int a = r * W + s, b = a + 1;
        v[1] = nan_max(v[1], wave(P, uy[a], uy[b], T[a], T[b]));
        const float cy = xi(tau_coef(P, T[r * W + clampi(s, 1, ny)]),
                            tau_coef(P, T[r * W + clampi(s + 1, 1, ny)]));
        v[3] = vs ? nan_max(v[3], cy) : nan_min(v[3], cy);
      }
    }
  }
  if (vs) {
    // rho = p*(1/(R*T)) once per staged cell: the tile and two rings, with
    // zero-gradient ghosts
    for (int k = tid; k < ER * EL; k += BX * BY) {
      const int i = k / EL, j = k % EL;
      const int g = clampi(r0 - 2 + i, 1, nx) * W + clampi(s0 - 2 + j, 1, ny);
      rho_t[i][j] = __fmul_rn(p[g], __fdiv_rn(1.0f, __fmul_rn(P.R, T[g])));
    }
    for (int k = tid; k < SR * SL; k += BX * BY) {
      const int i = k / SL, j = k % SL;
      sc_t[i][j] = sc[clampi(r0 - 1 + i, 1, nx) * W + clampi(s0 - 1 + j, 1, ny)];
    }
    __syncthreads();
    // raw over the tile and one ring; entries outside the interior are
    // never read (ring 1 replicates the edge cell there)
    for (int k = tid; k < SR * SL; k += BX * BY) {
      const int i = k / SL, j = k % SL;
      const int rc = r0 - 1 + i, scl = s0 - 1 + j;
      if (rc >= 1 && rc <= nx && scl >= 1 && scl <= ny) {
        raw_t[i][j] = raw_sensor(P, rho_t, i + 1, j + 1, sc_t[i][j]);
      }
    }
    __syncthreads();
    const float inv = smooth_inverse(P.smooth_ratio);
#pragma unroll
    for (int m = 0; m < ETR / BY; ++m) {
#pragma unroll
      for (int n = 0; n < ETL / BX; ++n) {
        const int r = r0 + ty + BY * m, s = s0 + tx + BX * n;
        if (r < 1 || r > nx || s < 1 || s > ny) continue;
        const int i = ty + BY * m + 1, j = tx + BX * n + 1;
        const float f = raw_t[i][j];
        const float up = r < nx ? raw_t[i + 1][j] : f;
        const float dn = r > 1 ? raw_t[i - 1][j] : f;
        const float le = s < ny ? raw_t[i][j + 1] : f;
        const float ri = s > 1 ? raw_t[i][j - 1] : f;
        const float s1 = smooth_ring<true>(
            f, nan_max(nan_max(f, nan_max(up, dn)), nan_max(le, ri)), P.smooth_ratio,
            inv);
        const int o = (r - 1) * ny + (s - 1);
        sc_raw[o] = f;
        sc_s1[o] = s1;
        if (s1 > f) v[4] = 1.0f;
      }
    }
  }
  fold_emit<NWARP>(v, vs, slots);
  if (tid == 0) {
    float* out = partials + EMIT_NP * (blockIdx.y * gridDim.x + blockIdx.x);
    for (int q = 0; q < 5; ++q) out[q] = v[q];
  }
}

// Pass 2: one block folds the partials into the rates (and the flag):
// co_rate = max(wave_x/h_x, wave_y/h_y) (times 1/h, as the reference),
// tau_rate = min over axes of alpha/max(c_f)*h or min(alpha/c)_f*h.
__global__ void __launch_bounds__(RED)
qgd2d_emit_final_kernel(QGDParams P, const float* __restrict__ partials,
                        int n, float* __restrict__ rates,
                        float* __restrict__ chg) {
  __shared__ float slots[5][RED / 32];
  const int tid = threadIdx.x;
  const bool vs = P.varsc != 0;
  const float c_id = vs ? -INFINITY : INFINITY;
  float v[5] = {-INFINITY, -INFINITY, c_id, c_id, 0.0f};
  for (int i = tid; i < n; i += RED) {
    const float* q = partials + EMIT_NP * i;
    v[0] = nan_max(v[0], q[0]);
    v[1] = nan_max(v[1], q[1]);
    v[2] = vs ? nan_max(v[2], q[2]) : nan_min(v[2], q[2]);
    v[3] = vs ? nan_max(v[3], q[3]) : nan_min(v[3], q[3]);
    v[4] = nan_max(v[4], q[4]);
  }
  fold_emit<RED / 32>(v, vs, slots);
  if (tid == 0) {
    rates[0] = nan_max(__fmul_rn(v[0], P.inv_hfx), __fmul_rn(v[1], P.inv_hfy));
    rates[1] = vs ? nan_min(__fmul_rn(__fdiv_rn(P.alpha, v[2]), P.hfx),
                          __fmul_rn(__fdiv_rn(P.alpha, v[3]), P.hfy))
                  : nan_min(__fmul_rn(v[2], P.hfx), __fmul_rn(v[3], P.hfy));
    if (vs) chg[0] = v[4];
  }
}

// ---------------------------------------------------------------------------
// qgd2d_smooth: the rest of fvc::smooth, k rings per launch
// ---------------------------------------------------------------------------
//
// Replaces the XLA loop qgdsolver_tpu/physics/qgdcoeffs.py:254
// (fvc_smooth_continue, a lax.while_loop of rings) that carries the
// emitted ring 1 to the fixed point of f <- max(f, nbr_max(f)/maxRatio).
// A ring on its own is bounded by memory (one frame in, one out, ~0.02 ms
// at 4096x2048) but ~16 of them run per step on an active sensor.  So a
// block loads an SMRN x SMLN tile of the input once, runs k rings on it in
// registers (ring j is valid on the tile shrunk by j cells, so the block
// writes the (SMRN - 2k) x (SMLN - 2k) cells in the middle) and writes them
// into the sensor frame with edge-replicated ghosts: k rings for the bytes
// of one.  The flag is set when the last ring raised a written cell: if it
// raised none, the frame is at the fixed point, and the host stops.  Every
// ring is the same deterministic map and the fixed point is idempotent, so
// the result does not depend on k or on how the rings are grouped: it is
// the plain version's fvc_smooth bit for bit.
//
// A ring is a handful of instructions a cell (smooth_ring.cuh: no division),
// so the layout keeps everything else off its path:
//   - a warp spans the tile's 128 lanes, 4 to a thread, and each of its
//     SMW warps owns SMRW rows: a thread's 32 cells stay in registers over
//     all k rings; neighbours within its rows are registers, across lanes
//     warp shuffles, and only the first and last row of each warp cross
//     warps, through shared memory in two buffers used in turn: one barrier
//     a ring;
//   - cells beyond a physical edge hold -FLT_MAX and keep it, so the max
//     ignores them, which is the plain version's edge replication; only
//     blocks whose tile crosses an edge (EDGE) pay that select;
//   - a tile whose cells all are at least SMOOTH_TINY (every sensor tile:
//     the sensor is clamped at cqSc or above) takes the ring without its
//     underflow test (GUARD = false); on the 4096x2048 case's sensor the
//     guarded ring in every tile took 1.14x (8 rings) and 1.23x (16 rings)
//     the time, with more spills (ab_kernels.py, PERF.md).

constexpr int SMV = 4;               // lanes a thread owns
constexpr int SMLN = 32 * SMV;       // lanes of a tile
constexpr int SMRW = 8;              // rows a thread owns
constexpr int SMW = 16;              // warps of a block, stacked along x
constexpr int SMRN = SMRW * SMW;     // rows of a tile
constexpr int SMOOTH_KMAX = 16;      // rings a launch may run
constexpr unsigned FULL = 0xffffffffu;

// One ring over a thread's cells v: up / dn are the rows above and below
// its first and last row.  Cells beyond a physical edge (EDGE: rin / lin
// false) stay -FLT_MAX.  LAST: return whether the ring raised a cell of the
// tile's middle that lies in the mesh.
template <bool EDGE, bool GUARD, bool LAST>
__device__ __forceinline__ bool smooth_pass(float (&v)[SMRW][SMV],
                                            const float (&up)[SMV],
                                            const float (&dn)[SMV], float r,
                                            float y, const bool (&rin)[SMRW],
                                            const bool (&lin)[SMV], int a0,
                                            int b0, int k) {
  bool raised = false;
  float prev[SMV];
#pragma unroll
  for (int c = 0; c < SMV; ++c) prev[c] = up[c];
#pragma unroll
  for (int i = 0; i < SMRW; ++i) {
    float cur[SMV], nxt[SMV];
#pragma unroll
    for (int c = 0; c < SMV; ++c) {
      cur[c] = v[i][c];
      nxt[c] = i + 1 < SMRW ? v[i + 1][c] : dn[c];
    }
    // lane 0's left and lane 31's right are outside the tile: any value
    const float le = __shfl_up_sync(FULL, cur[SMV - 1], 1);
    const float ri = __shfl_down_sync(FULL, cur[0], 1);
#pragma unroll
    for (int c = 0; c < SMV; ++c) {
      float nb = nan_max(nan_max(cur[c], prev[c]), nxt[c]);
      nb = nan_max(nb, nan_max(c > 0 ? cur[c - 1] : le,
                           c + 1 < SMV ? cur[c + 1] : ri));
      float nv = smooth_ring<GUARD>(cur[c], nb, r, y);
      if (EDGE && !(rin[i] && lin[c])) nv = -FLT_MAX;
      if (LAST && nv > cur[c] && a0 + i >= k && a0 + i < SMRN - k &&
          b0 + c >= k && b0 + c < SMLN - k && (!EDGE || (rin[i] && lin[c])))
        raised = true;
      v[i][c] = nv;
    }
#pragma unroll
    for (int c = 0; c < SMV; ++c) prev[c] = cur[c];
  }
  return raised;
}

// k rings over the tile; whether the last raised a written cell.  xr: the
// first and last rows of every warp, [buffer][first/last][warp][lane].
template <bool EDGE, bool GUARD>
__device__ __forceinline__ bool smooth_rings(float (&v)[SMRW][SMV], int k,
                                             float r, float y,
                                             const bool (&rin)[SMRW],
                                             const bool (&lin)[SMV],
                                             float4 (*xr)[2][SMW][32]) {
  const int tx = threadIdx.x, w = threadIdx.y;
  const int a0 = w * SMRW, b0 = tx * SMV;
  for (int j = 1; j <= k; ++j) {
    float4(*x)[SMW][32] = xr[j & 1];
    x[0][w][tx] = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    x[1][w][tx] = make_float4(v[SMRW - 1][0], v[SMRW - 1][1],
                              v[SMRW - 1][2], v[SMRW - 1][3]);
    __syncthreads();
    // the tile's first and last rows: any value (their own)
    const float4 u = w > 0 ? x[1][w - 1][tx] : x[0][w][tx];
    const float4 d = w + 1 < SMW ? x[0][w + 1][tx] : x[1][w][tx];
    const float up[SMV] = {u.x, u.y, u.z, u.w};
    const float dn[SMV] = {d.x, d.y, d.z, d.w};
    if (j < k) {
      smooth_pass<EDGE, GUARD, false>(v, up, dn, r, y, rin, lin, a0, b0, k);
    } else {
      return smooth_pass<EDGE, GUARD, true>(v, up, dn, r, y, rin, lin, a0,
                                            b0, k);
    }
  }
  return false;
}

__global__ void __launch_bounds__(32 * SMW, 2)
qgd2d_smooth_kernel(QGDParams P, const float* __restrict__ in, int pitch,
                    int k, float* __restrict__ out, float* __restrict__ chg) {
  __shared__ float4 xr[2][2][SMW][32];
  const int tx = threadIdx.x, w = threadIdx.y;
  const int nx = P.nx, ny = P.ny;
  const long W = ny + 2;
  // the interior cell of tile cell (0, 0), and of this thread's first cell
  const int i0 = blockIdx.y * (SMRN - 2 * k) - k;
  const int j0 = blockIdx.x * (SMLN - 2 * k) - k;
  const int gi0 = i0 + w * SMRW, gj0 = j0 + tx * SMV;
  // the tile crosses a physical edge, or (k = 0) ends on one: its cells
  // there need their ghosts
  const bool edge = i0 <= 0 || j0 <= 0 || i0 + SMRN >= nx || j0 + SMLN >= ny;
  bool rin[SMRW], lin[SMV];
#pragma unroll
  for (int i = 0; i < SMRW; ++i) rin[i] = gi0 + i >= 0 && gi0 + i < nx;
#pragma unroll
  for (int c = 0; c < SMV; ++c) lin[c] = gj0 + c >= 0 && gj0 + c < ny;
  float v[SMRW][SMV];
  bool big = true;
#pragma unroll
  for (int i = 0; i < SMRW; ++i) {
#pragma unroll
    for (int c = 0; c < SMV; ++c) {
      const bool inside = !edge || (rin[i] && lin[c]);
      v[i][c] = inside ? in[(long)(gi0 + i) * pitch + gj0 + c] : -FLT_MAX;
      if (inside) big = big && v[i][c] >= SMOOTH_TINY;
    }
  }
  big = __syncthreads_and(big);
  const float r = P.smooth_ratio, y = smooth_inverse(r);
  bool raised;
  if (edge) {
    raised = big ? smooth_rings<true, false>(v, k, r, y, rin, lin, xr)
                 : smooth_rings<true, true>(v, k, r, y, rin, lin, xr);
  } else {
    raised = big ? smooth_rings<false, false>(v, k, r, y, rin, lin, xr)
                 : smooth_rings<false, true>(v, k, r, y, rin, lin, xr);
  }
  if (__syncthreads_or(raised) && tx == 0 && w == 0) chg[0] = 1.0f;
  // the cells in the middle, and the ghosts beside the edge cells
#pragma unroll
  for (int i = 0; i < SMRW; ++i) {
    const int a = w * SMRW + i, gi = gi0 + i;
    if (a < k || a >= SMRN - k || !rin[i]) continue;
#pragma unroll
    for (int c = 0; c < SMV; ++c) {
      const int b = tx * SMV + c, gj = gj0 + c;
      if (b < k || b >= SMLN - k || !lin[c]) continue;
      const float f = v[i][c];
      out[(gi + 1) * W + gj + 1] = f;
      if (!edge) continue;
      const long rows[2] = {gi == 0 ? 0 : -1, gi == nx - 1 ? nx + 1 : -1};
      const long lanes[2] = {gj == 0 ? 0 : -1, gj == ny - 1 ? ny + 1 : -1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (rows[e] >= 0) out[rows[e] * W + gj + 1] = f;
        if (lanes[e] >= 0) out[(gi + 1) * W + lanes[e]] = f;
#pragma unroll
        for (int g = 0; g < 2; ++g)
          if (rows[e] >= 0 && lanes[g] >= 0) out[rows[e] * W + lanes[g]] = f;
      }
    }
  }
}

// Counts, in bad[0..4], the floats nb of five ranges where smooth_div<true>
// and __fdiv_rn give different bits: [1, 2), the binade at SMOOTH_TINY
// (the fast formula's lowest), the lowest normal binade, the subnormals
// (and +0) and the top binade.  blockIdx.y picks the range.  y is derived
// from r as the smoothing kernels derive it.
__global__ void smooth_ring_check_kernel(float r, unsigned* __restrict__ bad) {
  const unsigned first[5] = {0x3F800000u, 0u, 0x00800000u, 0u, 0x7F000000u};
  const unsigned start = blockIdx.y == 1 ? __float_as_uint(SMOOTH_TINY)
                                         : first[blockIdx.y];
  const float y = smooth_inverse(r);
  unsigned count = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < (1u << 23);
       i += gridDim.x * blockDim.x) {
    const float nb = __uint_as_float(start + i);
    count += __float_as_uint(smooth_div<true>(nb, r, y)) !=
             __float_as_uint(__fdiv_rn(nb, r));
  }
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(bad + blockIdx.y, count);
}

// qgd2d_dt's grid at (nx, ny): a warp for each strip of DT_OWN lanes and
// chunk of DT_CX rows, DT_WARPS warps a block; strips receives the strips.
int dt2_blocks(int nx, int ny, int* strips) {
  *strips = (ny + 1 + DT_OWN - 1) / DT_OWN;
  const long warps = (long)*strips * ((nx + 2 + DT_CX - 1) / DT_CX);
  return static_cast<int>((warps + DT_WARPS - 1) / DT_WARPS);
}

cudaError_t dt2_launch(const QGDParams& P, const float* T, const float* ux,
                       const float* uy, int mode, const float* dt_old,
                       float* work, float* out, cudaStream_t st) {
  int strips = 0;
  const int blocks = dt2_blocks(P.nx, P.ny, &strips);
  qgd2d_dt_kernel<<<blocks, DT_NT, 0, st>>>(P, T, ux, uy, strips, mode,
                                            dt_old, work, out);
  return cudaGetLastError();
}

// The update's chunk of rows at this shape on the current device: the
// longest of 32, 16, 8, 4 rows whose grid still gives every SM four waves
// of resident blocks (or 4).
int update_chunk(int nx, int ny, int* blocks_per_sm) {
  static int sms[64] = {}, bps[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
  if (sms[dev] == 0) {
    if (cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &bps[dev], qgd2d_update_kernel, UT, 0) != cudaSuccess) {
      sms[dev] = 0;
      return -1;
    }
  }
  if (blocks_per_sm) *blocks_per_sm = bps[dev];
  const long strips = (ny + UL - 1) / UL;
  const long want = 4L * sms[dev] * bps[dev];
  int cx = 32;
  while (cx > 4 && strips * ((nx + cx - 1) / cx) < want) cx /= 2;
  return cx;
}

}  // namespace

extern "C" {

// The dt workspace's partials: one per block of the launch at (nx, ny).
// The workspace holds DT_HEAD floats (the ticket, 0 before the first
// launch) and DT_NQ per partial.
int qgd2d_dt_partials(int nx, int ny) {
  int strips = 0;
  return dt2_blocks(nx, ny, &strips);
}

const char* qgd2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int qgd2d_dt(const QGDParams* prm, const float* T, const float* ux,
             const float* uy, const float* dt_old, float* work, float* dt_new,
             void* stream) {
  return static_cast<int>(dt2_launch(*prm, T, ux, uy, DT_FULL, dt_old, work,
                                     dt_new,
                                     static_cast<cudaStream_t>(stream)));
}

// This block's dt folded to the quad (max wave x, max wave y, -min tau,
// 0): what a MAX all-reduce over the ranks combines.
int qgd2d_dt_fold(const QGDParams* prm, const float* T, const float* ux,
                  const float* uy, float* work, float* quad, void* stream) {
  return static_cast<int>(dt2_launch(*prm, T, ux, uy, DT_FOLD, nullptr, work,
                                     quad,
                                     static_cast<cudaStream_t>(stream)));
}

// setDeltaT on a reduced quad of qgd2d_dt_fold.
int qgd2d_dt_apply(const QGDParams* prm, const float* quad,
                   const float* dt_old, float* dt_new, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qgd2d_dt_apply_kernel<<<1, 1, 0, st>>>(*prm, quad, dt_old, dt_new);
  return static_cast<int>(cudaGetLastError());
}

// The dt launch's shape at (nx, ny) on the current device: out = {lanes a
// warp owns, warps a block, chunk rows, blocks, resident blocks per SM}.
int qgd2d_dt_shape(int nx, int ny, int* out) {
  int strips = 0;
  out[0] = DT_OWN;
  out[1] = DT_WARPS;
  out[2] = DT_CX;
  out[3] = dt2_blocks(nx, ny, &strips);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], qgd2d_dt_kernel, DT_NT, 0));
}

int qgd2d_update(const QGDParams* prm, const float* p, const float* T,
                 const float* ux, const float* uy, const float* sc,
                 const float* dt, float* pn, float* Tn, float* uxn, float* uyn,
                 float* side, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cx = update_chunk(prm->nx, prm->ny, nullptr);
  if (cx < 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((prm->ny + UL - 1) / UL, (prm->nx + cx - 1) / cx);
  qgd2d_update_kernel<<<grid, UT, 0, st>>>(*prm, p, T, ux, uy, sc, dt, pn, Tn,
                                           uxn, uyn, side, cx);
  return static_cast<int>(cudaGetLastError());
}

// The update's launch shape at (nx, ny) on the current device: out =
// {strip lanes, chunk rows, static shared bytes per block, resident blocks
// per SM, blocks of the grid}.
int qgd2d_update_shape(int nx, int ny, int* out) {
  int bps = 0;
  const int cx = update_chunk(nx, ny, &bps);
  if (cx < 0) return static_cast<int>(cudaGetLastError());
  out[0] = UL;
  out[1] = cx;
  out[2] = static_cast<int>(sizeof(float)) * (NSLOT * SLOT + 4 * UYF);
  out[3] = bps;
  out[4] = ((ny + UL - 1) / UL) * ((nx + cx - 1) / cx);
  return 0;
}

// Every ghost of the four fresh frames (qgd2d_ghosts_kernel), one launch.
int qgd2d_ghosts(const QGDParams* prm, const float* prof, const float* side,
                 float* p, float* T, float* ux, float* uy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Ghosts2 G;
  G.prof = prof;
  G.side = side;
  G.f[0] = p;
  G.f[1] = T;
  G.f[2] = ux;
  G.f[3] = uy;
  const long cells = 2L * prm->ny + 2L * (prm->nx + 2);
  qgd2d_ghosts_kernel<<<dim3((unsigned)((cells + GT - 1) / GT), 4), GT, 0,
                        st>>>(*prm, G);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of qgd2d_emit's tile grid: the length of its partials.
int qgd2d_emit_partials(int nx, int ny) {
  return ((ny + 1 + ETL - 1) / ETL) * ((nx + 1 + ETR - 1) / ETR);
}

int qgd2d_emit(const QGDParams* prm, const float* p, const float* T,
               const float* ux, const float* uy, const float* sc,
               float* partials, float* rates, float* sc_raw, float* sc_s1,
               float* chg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(BX, BY);
  const dim3 grid((prm->ny + 1 + ETL - 1) / ETL, (prm->nx + 1 + ETR - 1) / ETR);
  qgd2d_emit_partial_kernel<<<grid, block, 0, st>>>(*prm, p, T, ux, uy, sc,
                                                    partials, sc_raw, sc_s1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  qgd2d_emit_final_kernel<<<1, RED, 0, st>>>(
      *prm, partials, static_cast<int>(grid.x * grid.y), rates, chg);
  return static_cast<int>(cudaGetLastError());
}

// k fvc::smooth rings (0 <= k <= SMOOTH_KMAX) of the (nx, ny) cells at in
// (cell (i, j) at in[i * pitch + j]) into the frame out, ghosts
// edge-replicated; chg <- 1 if the last ring raised a cell, else 0.
int qgd2d_smooth(const QGDParams* prm, const float* in, int pitch, int k,
                 float* out, float* chg, void* stream) {
  if (k < 0 || k > SMOOTH_KMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(chg, 0, sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((prm->ny + SMLN - 2 * k - 1) / (SMLN - 2 * k),
                  (prm->nx + SMRN - 2 * k - 1) / (SMRN - 2 * k));
  qgd2d_smooth_kernel<<<grid, dim3(32, SMW), 0, st>>>(*prm, in, pitch, k, out,
                                                      chg);
  return static_cast<int>(cudaGetLastError());
}

// The division-free ring against __fdiv_rn for maxRatio r: bad[0..4]
// (device, zeroed here) <- the mismatches in each range of
// smooth_ring_check_kernel.
int smooth_ring_check(float r, unsigned* bad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bad, 0, 5 * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  smooth_ring_check_kernel<<<dim3(512, 5), 256, 0, st>>>(r, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
