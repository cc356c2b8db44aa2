// elle_trim: Elle's peel-to-core cycle existence test, for Hopper
// (sm_90a).
//
// Replaces jepsen_tpu/elle/tpu.py::make_trim_kernel (jitted by
// _compiled_trim). Per edge-type subset s, a node stays live while it
// has a live predecessor AND a live successor, from
//   * the padded neighbor lists (in/out, degree buckets d_in/d_out) and
//     their per-subset masks,
//   * the process chains: a strictly earlier / later live op of the
//     same process (per-process segment min/max of chain positions),
//   * the anchored realtime thresholds: the min completion event over
//     live nodes with non-realtime in-support (or inverted intervals)
//     and the max invocation event symmetrically, each with its first
//     argmin/argmax and a second extremum that masks that ROW only.
// A loop body runs two peels and records the per-subset live counts in
// row min(i, counts_rows - 1); the loop runs while any subset's count
// changed, at most n_pad bodies. The plain PyTorch version is
// jepsen_tpu_torch/elle/tpu.py::trim_ref; outputs agree exactly.
//
// What bounds it. A peel reads the neighbor lists and masks (n_pad (d_in
// + d_out) 5 B per subset) and the node arrays, a few hundred KB at the
// 3k-txn cells, and every peel depends on the last: it is a chain of
// block-wide reductions, bound by latency, not by bytes or operations.
//
// What this design does about it. The subsets are independent, so one
// persistent 1024-thread CTA per subset runs its whole fixpoint on the
// device: the live set (n_pad bytes, twice) and the per-node support
// flags sit in shared memory, the segment min/max in shared memory
// (global scratch when p_pad is too large), and a peel is four barriers
// with warp-shuffle reductions. The reference's joint stop rule (run
// while ANY subset changed) is reproduced exactly: a subset whose count
// repeated is at its fixpoint, so its CTA stops there, fills its later
// counts rows with its final count, and the last CTA to finish (a
// ticket) takes the max body count and zeroes the rows past it. A
// grid-wide round over several SMs per subset is later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemProcs = 4096;   // segment arrays in shared memory up to
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* in_neigh;   // (n_pad, d_in)
  const uint8_t* in_mask;    // (n_pad, d_in, S)
  const int32_t* out_neigh;  // (n_pad, d_out)
  const uint8_t* out_mask;   // (n_pad, d_out, S)
  const int32_t* inv;        // (n_pad,) clipped invocation events
  const int32_t* comp;       // (n_pad,) clipped completion events
  const int32_t* proc;       // (n_pad,) process segment
  const int32_t* ppos;       // (n_pad,) chain position, -1 absent
  const uint8_t* live0;      // (n_pad, S)
  uint8_t* live_out;         // (n_pad, S)
  int32_t* counts;           // (rows, S)
  int32_t* bodies;           // ()
  int32_t* scratch;          // [ticket, bodies per subset, segments]
  int n_pad, d_in, d_out, S, p_pad, use_rt, use_proc, rows;
};

// (value, index, second value): the extremum with its FIRST index and
// the extremum over every other row
struct Ext {
  int v1, i1, v2;
};

__device__ __forceinline__ Ext min_ext(Ext a, Ext b) {
  if (b.v1 < a.v1 || (b.v1 == a.v1 && b.i1 < a.i1))
    return {b.v1, b.i1, min(a.v1, b.v2)};
  return {a.v1, a.i1, min(a.v2, b.v1)};
}

__device__ __forceinline__ Ext max_ext(Ext a, Ext b) {
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1))
    return {b.v1, b.i1, max(a.v1, b.v2)};
  return {a.v1, a.i1, max(a.v2, b.v1)};
}

__device__ __forceinline__ Ext shfl_ext(Ext e, int delta) {
  return {__shfl_down_sync(kFull, e.v1, delta),
          __shfl_down_sync(kFull, e.i1, delta),
          __shfl_down_sync(kFull, e.v2, delta)};
}

struct Shared {
  Ext red_min[kWarps];
  Ext red_max[kWarps];
  int red_sum[kWarps];
  Ext min_out, max_out;
  int sum_out;
  int last;
};

// block-wide min/max extremum pair; every thread gets the results
__device__ void reduce_ext(Shared& sh, Ext mn, Ext mx, Ext& mn_out,
                           Ext& mx_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min_ext(mn, shfl_ext(mn, d));
    mx = max_ext(mx, shfl_ext(mx, d));
  }
  if (lane == 0) {
    sh.red_min[warp] = mn;
    sh.red_max[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = sh.red_min[lane];
    mx = sh.red_max[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      mn = min_ext(mn, shfl_ext(mn, d));
      mx = max_ext(mx, shfl_ext(mx, d));
    }
    if (lane == 0) {
      sh.min_out = mn;
      sh.max_out = mx;
    }
  }
  __syncthreads();
  mn_out = sh.min_out;
  mx_out = sh.max_out;
}

__device__ int reduce_sum(Shared& sh, int v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) sh.red_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = __reduce_add_sync(kFull, sh.red_sum[lane]);
    if (lane == 0) sh.sum_out = v;
  }
  __syncthreads();
  return sh.sum_out;
}

// one peel of subset s: live -> nlive
__device__ void peel(const Params& p, int s, const uint8_t* live,
                     uint8_t* nlive, uint8_t* flags, int* minpp,
                     int* maxpp, Shared& sh) {
  const int tid = threadIdx.x;
  if (p.use_proc) {
    for (int q = tid; q < p.p_pad; q += kThreads) {
      minpp[q] = kBig;
      maxpp[q] = -kBig;
    }
    __syncthreads();
    for (int i = tid; i < p.n_pad; i += kThreads) {
      if (live[i]) {
        atomicMin(&minpp[p.proc[i]], p.ppos[i]);
        atomicMax(&maxpp[p.proc[i]], p.ppos[i]);
      }
    }
    __syncthreads();
  }
  // support from the neighbor lists and the process chains
  for (int i = tid; i < p.n_pad; i += kThreads) {
    uint8_t f = 0;
    if (live[i]) {
      bool hi = false, ho = false;
      const int32_t* nb = p.in_neigh + static_cast<size_t>(i) * p.d_in;
      const uint8_t* mk = p.in_mask + static_cast<size_t>(i) * p.d_in * p.S;
      for (int d = 0; d < p.d_in && !hi; ++d)
        hi = mk[d * p.S + s] && live[nb[d]];
      nb = p.out_neigh + static_cast<size_t>(i) * p.d_out;
      mk = p.out_mask + static_cast<size_t>(i) * p.d_out * p.S;
      for (int d = 0; d < p.d_out && !ho; ++d)
        ho = mk[d * p.S + s] && live[nb[d]];
      if (p.use_proc) {
        const int pp = p.ppos[i], pr = p.proc[i];
        hi = hi || pp > minpp[pr];
        ho = ho || (pp < maxpp[pr] && pp >= 0);
      }
      f = static_cast<uint8_t>(hi) | (static_cast<uint8_t>(ho) << 1);
    }
    flags[i] = f;
  }
  Ext mn = {INT_MAX, INT_MAX, INT_MAX}, mx = {INT_MIN, INT_MAX, INT_MIN};
  if (p.use_rt) {
    __syncthreads();
    // anchored threshold pools over every row (padding included, as the
    // reference's argmin/argmax over n_pad rows)
    for (int i = tid; i < p.n_pad; i += kThreads) {
      const bool inverted = p.comp[i] < p.inv[i];
      const bool pool_in = live[i] && ((flags[i] & 1) || inverted);
      const bool pool_out = live[i] && ((flags[i] & 2) || inverted);
      mn = min_ext(mn, Ext{pool_in ? p.comp[i] : kBig, i, INT_MAX});
      mx = max_ext(mx, Ext{pool_out ? p.inv[i] : -kBig, i, INT_MIN});
    }
    reduce_ext(sh, mn, mx, mn, mx);
  }
  for (int i = tid; i < p.n_pad; i += kThreads) {
    bool hi = flags[i] & 1, ho = flags[i] & 2;
    if (p.use_rt) {
      hi = hi || p.inv[i] > (i == mn.i1 ? mn.v2 : mn.v1);
      ho = ho || p.comp[i] < (i == mx.i1 ? mx.v2 : mx.v1);
    }
    nlive[i] = live[i] && hi && ho;
  }
  __syncthreads();
}

// grid (S), block 1024, dynamic shared memory 3 n_pad B (+ segments)
__global__ void __launch_bounds__(kThreads, 1) trim_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared sh;
  const int s = blockIdx.x, tid = threadIdx.x;
  uint8_t* live_a = smem;
  uint8_t* live_b = smem + p.n_pad;
  uint8_t* flags = smem + 2 * p.n_pad;
  int* minpp;
  int* maxpp;
  if (p.p_pad <= kSmemProcs) {
    minpp = reinterpret_cast<int*>(smem + 3 * p.n_pad);
    maxpp = minpp + p.p_pad;
  } else {
    minpp = p.scratch + 1 + p.S + 2 * s * p.p_pad;
    maxpp = minpp + p.p_pad;
  }
  for (int i = tid; i < p.n_pad; i += kThreads)
    live_a[i] = p.live0[static_cast<size_t>(i) * p.S + s] != 0;
  __syncthreads();

  int prev = -1, c = 0, i = 0;
  while (i < p.n_pad) {
    peel(p, s, live_a, live_b, flags, minpp, maxpp, sh);
    peel(p, s, live_b, live_a, flags, minpp, maxpp, sh);
    int local = 0;
    for (int k = tid; k < p.n_pad; k += kThreads) local += live_a[k];
    c = reduce_sum(sh, local);
    if (tid == 0) p.counts[min(i, p.rows - 1) * p.S + s] = c;
    ++i;
    if (c == prev) break;
    prev = c;
  }
  // a stable subset repeats its final count in every later body
  for (int r = i + tid; r < p.rows; r += kThreads) p.counts[r * p.S + s] = c;
  for (int k = tid; k < p.n_pad; k += kThreads)
    p.live_out[static_cast<size_t>(k) * p.S + s] = live_a[k];

  // the last CTA to finish applies the joint stop: bodies = the max
  // over subsets, counts rows past it zero
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    p.scratch[1 + s] = i;
    __threadfence();
    sh.last = atomicAdd(&p.scratch[0], 1) == p.S - 1;
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  int total = 0;
  for (int k = 0; k < p.S; ++k)
    total = max(total, static_cast<volatile int32_t*>(p.scratch)[1 + k]);
  if (tid == 0) *p.bodies = total;
  for (int r = total + tid; r < p.rows; r += kThreads)
    for (int k = 0; k < p.S; ++k) p.counts[r * p.S + k] = 0;
}

}  // namespace

extern "C" int elle_trim(const int32_t* in_neigh, const uint8_t* in_mask,
                         const int32_t* out_neigh, const uint8_t* out_mask,
                         const int32_t* inv, const int32_t* comp,
                         const int32_t* proc, const int32_t* ppos,
                         const uint8_t* live0, uint8_t* live_out,
                         int32_t* counts, int32_t* bodies, int32_t* scratch,
                         int n_pad, int d_in, int d_out, int S, int p_pad,
                         int use_rt, int use_proc, int rows, void* stream) {
  const Params p{in_neigh, in_mask, out_neigh, out_mask, inv,   comp,
                 proc,     ppos,    live0,     live_out, counts, bodies,
                 scratch,  n_pad,   d_in,      d_out,    S,      p_pad,
                 use_rt,   use_proc, rows};
  size_t smem = 3 * static_cast<size_t>(n_pad);
  smem = (smem + 15) & ~static_cast<size_t>(15);
  if (p_pad <= kSmemProcs) smem += 2 * sizeof(int) * p_pad;
  cudaError_t e = cudaFuncSetAttribute(
      trim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  trim_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* elle_trim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
