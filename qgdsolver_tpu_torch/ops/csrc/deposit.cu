// Hand-written Hopper (sm_90a) kernel: the deterministic deposition of
// per-parcel values into their owner cells.
//
// Replaces the scatter-adds of the Lagrangian clouds,
// qgdsolver_tpu/solvers/particles.py:160 and :168 (the momentum and energy
// sources) and :372 (the evaporated mass): `.at[flat].add`, an XLA
// scatter, not a Pallas kernel.  On the CPU a scatter-add adds a cell's
// parcels in parcel order, starting from zero; atomics on the card add them
// in whatever order the warps arrive, so the sums change between runs.
// Here the caller sorts the parcels by cell with a stable sort (parcel order
// within a cell kept), and for each row (grid row y) the cell's run of
// sorted positions is summed in order with plain adds, starting from zero:
// every cell's sum is the one the CPU's scatter-add forms, bit for bit.
//
// An in-order sum is one chain of dependent adds, so a cell holding m
// parcels costs at least m adds' latency.  The thread at the start of a run
// finds its end by a galloping search of the sorted cells (log m reads).
// A short run (the common case: a few parcels a cell) it sums alone.  A
// long one (more than a warp's width; a warp's 32 positions hold at most
// one such start) its whole warp sums: the lanes load the run's values 32
// at a time, several chunks ahead, stage each chunk in shared memory, and
// every lane adds the staged chunk in order, so the loads' latency hides
// behind the chain, which then runs at about one add's latency a parcel.
//
// Inputs: values (k, n) row-major, order (n,) the stable sort permutation,
// cells (n,) the sorted cell of each position.  out (k, ncell) must hold
// zeros in the cells no parcel reaches; the kernel writes each occupied
// cell once per row.  A cell outside [0, ncell) is skipped: the caller
// gives parcels whose every value is zero such a cell, since adding a
// signed zero to a sum that starts from +0 changes no bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
// chunks of 32 values a lane keeps in flight ahead of the adds
constexpr int kAhead = 4;

__device__ __forceinline__ float plain_add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double plain_add(double a, double b) {
  return __dadd_rn(a, b);
}

// The end of the run of cell c that starts at i: the first position after
// i whose cell differs, or n (cells ascending).
__device__ __forceinline__ long long run_end(
    const long long* __restrict__ cells, long long n, long long i,
    long long c) {
  long long good = i, bad = n, step = 1;
  while (good + step < n) {
    if (cells[good + step] != c) {
      bad = good + step;
      break;
    }
    good += step;
    step <<= 1;
  }
  while (bad - good > 1) {
    const long long mid = good + (bad - good) / 2;
    if (cells[mid] == c) {
      good = mid;
    } else {
      bad = mid;
    }
  }
  return bad;
}

// order[p] for a position p of the run [.., end), else -1
__device__ __forceinline__ long long index_at(
    const long long* __restrict__ order, long long p, long long end) {
  return p < end ? order[p] : -1;
}

template <typename T>
__device__ __forceinline__ T value_of(const T* __restrict__ v, long long k) {
  return k >= 0 ? v[k] : T(0);
}

// v[order[a]] + ... + v[order[end - 1]] in order from zero, by the whole
// warp through its 32 slots of shared memory, `stage` (every lane returns
// the sum).  Lane l holds, for the chunks of 32 positions j, the value at
// j + l kAhead chunks ahead of the adds and its index 2 kAhead chunks
// ahead, each register reloaded where it is consumed: no load waits on
// another load, and no register is copied while its load is in flight.
template <typename T>
__device__ T warp_run_sum(const T* __restrict__ v,
                          const long long* __restrict__ order, long long a,
                          long long end, int lane, T* stage) {
  long long idx[kAhead];
  T val[kAhead];
#pragma unroll
  for (int q = 0; q < kAhead; ++q)
    idx[q] = index_at(order, a + q * kWarp + lane, end);
#pragma unroll
  for (int q = 0; q < kAhead; ++q) {
    val[q] = value_of(v, idx[q]);
    idx[q] = index_at(order, a + (q + kAhead) * kWarp + lane, end);
  }
  T s = T(0);
  for (long long j = a; j < end; j += kAhead * kWarp) {
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long jq = j + q * kWarp;
      if (jq >= end) break;  // the same on every lane
      stage[lane] = val[q];
      val[q] = value_of(v, idx[q]);
      idx[q] = index_at(order, jq + 2 * kAhead * kWarp + lane, end);
      __syncwarp();
      if (end - jq >= kWarp) {
        T w[kWarp];
#pragma unroll
        for (int u = 0; u < kWarp; ++u) w[u] = stage[u];
#pragma unroll
        for (int u = 0; u < kWarp; ++u) s = plain_add(s, w[u]);
      } else {
        const int m = static_cast<int>(end - jq);
        for (int u = 0; u < m; ++u) s = plain_add(s, stage[u]);
      }
      __syncwarp();
    }
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const T* __restrict__ values, long long n,
               const long long* __restrict__ order,
               const long long* __restrict__ cells, T* __restrict__ out,
               long long ncell) {
  __shared__ __align__(16) T stage[kThreads];
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  const long long r = blockIdx.y;
  const T* v = values + r * n;
  T* o = out + r * ncell;
  // no early return: every lane reaches the ballot
  long long c = -1, end = i;
  bool start = false;
  if (i < n) {
    c = cells[i];
    start = c >= 0 && c < ncell && (i == 0 || cells[i - 1] != c);
  }
  if (start) end = run_end(cells, n, i, c);
  const bool long_run = start && end - i > kWarp;
  if (start && !long_run) {
    T s = T(0);
    for (long long j = i; j < end; ++j) s = plain_add(s, v[order[j]]);
    o[c] = s;
  }
  const unsigned todo = __ballot_sync(kAll, long_run);
  if (todo) {
    const int src = __ffs(todo) - 1;  // the warp's only long start
    const long long a = __shfl_sync(kAll, i, src);
    const long long e = __shfl_sync(kAll, end, src);
    const long long cc = __shfl_sync(kAll, c, src);
    const T s = warp_run_sum(v, order, a, e, lane,
                             stage + (threadIdx.x - lane));
    if (lane == src) o[cc] = s;
  }
}

template <typename T>
int launch(const T* values, long long n, int k, const long long* order,
           const long long* cells, T* out, long long ncell, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  // one grid row per value row
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(k));
  deposit_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, n, order, cells, out, ncell);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int deposit_f32(const float* values, long long n, int k,
                const long long* order, const long long* cells, float* out,
                long long ncell, void* stream) {
  return launch(values, n, k, order, cells, out, ncell, stream);
}

int deposit_f64(const double* values, long long n, int k,
                const long long* order, const long long* cells, double* out,
                long long ncell, void* stream) {
  return launch(values, n, k, order, cells, out, ncell, stream);
}

}  // extern "C"
