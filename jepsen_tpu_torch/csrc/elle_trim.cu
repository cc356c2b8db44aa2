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
// What bounds it. A peel reads only the last peel's live set, so the
// fixpoint is a chain of dependent peels (984 at the 3k list-append
// history, 3306 at 10k), each a block-wide step: bound by latency, not
// by bytes or operations. Few nodes die in a peel (about ten), yet a
// peel that re-checks every live node's padded lists pays d_in + d_out
// dependent device-memory loads a node.
//
// What this design does about it. One persistent 1024-thread CTA per
// subset runs the whole fixpoint (the subsets are independent), and a
// peel spends as few instructions and dependent memory trips as it can:
//   * A prologue on the device builds, for each node, the count of
//     masked in-slots and out-slots whose neighbor is live (packed in
//     one word, in shared memory), and the transposes of both padded
//     lists (for a source j, the nodes whose in-list names it, and
//     likewise for the out-list: a CSR built by a histogram, a block
//     scan and a fill; out_neigh need not mirror in_neigh). With the
//     realtime thresholds on, it also sorts the rows by (completion,
//     index) and by (-invocation, index) (a bitonic sort of 64-bit
//     keys).
//   * A node's live bit is a bit of its thread's word (node tid + 1024 m
//     is bit m). A peel reads has_in / has_out from the counts; the
//     process segments' min/max are recomputed from the live nodes with
//     shared atomics (two buffers by the peel's parity).
//   * The realtime pools only shrink (live shrinks, and the edge and
//     process support with it), so the first two members of a pool in
//     its sorted order only move forward: warps 0 and 1 keep a window of
//     32 sorted rows each in registers and find them by one ballot over
//     the pools' bits, which every warp writes by ballot. A block
//     reduction over every row (the first design) cost 2.5 µs a peel at
//     the 3k shape, the instructions of 1024 threads' extrema; the
//     pointers cost one barrier more and a few instructions.
//   * Only a node without edge or process support reads its events;
//     the nodes that die walk their transposed lists, one warp per dead
//     node, lanes on the entries, and decrement the counts they name
//     with shared atomics: in a real history only the few that die pay
//     a walk.
//   * Shared memory holds the counts and the pools' bits, then, where
//     they fit, the lists' ends, the event arrays and the lists'
//     entries (all of them at 3k txns; at n_pad 16384 the counts and
//     the ends).
// A peel is two barriers (every count read before a death's walk
// decrements one, then the peel's end), plus one for the realtime
// thresholds and one for the process segments when those are on. The reference's joint
// stop rule (run while ANY subset changed) is reproduced exactly: a
// subset whose count repeated is at its fixpoint, so its CTA stops
// there, fills its later counts rows with its final count, and the last
// CTA to finish (a ticket) takes the max body count and zeroes the rows
// past it.
//
// Scratch (int32 words, elle/tpu.py::trim_scratch_words): [ticket,
// bodies per subset] padded to an even count, then per subset the sort
// keys (N uint64), the lists' ends (2 N: the in-list transposes, then
// the out-list ones), the two row orders (2 N), the lists' entries
// (uint16 node ids, room for `slots`, the wrapper's count of the slots
// masked in any subset, padded to an even word count) and, with the
// process chains on past kSmemProcs segments, the two segment buffers
// (4 p_pad). A part is used where its shared copy does not fit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNodesPerThread = 32;  // a thread's live bits: one word
constexpr int kSmemProcs = 4096;  // segment buffers in shared memory up to
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOutOne = 1u << 16;  // one out-slot in a packed count

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
  int32_t* scratch;          // see the note
  int n_pad, d_in, d_out, S, p_pad, use_rt, use_proc, rows;
  // where shared memory holds them: the segment buffers, the lists'
  // ends, the event arrays, the lists' entries
  int seg_smem, ends_smem, ev_smem, ent_smem;
  long long head_words;      // [ticket, bodies per subset], even
  long long sub_words;       // scratch words per subset, even
  long long seg_off;         // the device segment buffers in a subset's
};

// (value, index, second value): the extremum with its FIRST index and
// the extremum over every other row
struct Ext {
  int v1, i1, v2;
};

// exclusive prefix sum of h[0, L) in place, by the block (h in shared or
// device memory); `part` holds kWarps ints
__device__ void block_scan(int* h, int L, int* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (L + kThreads - 1) / kThreads;
  const int lo = min(tid * per, L), hi = min(lo + per, L);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += h[k];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = part[lane];
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    part[lane] = x - v;
  }
  __syncthreads();
  int run = part[warp] + incl - sum;
  for (int k = lo; k < hi; ++k) {
    const int t = h[k];
    h[k] = run;
    run += t;
  }
  __syncthreads();
}

// Ascending bitonic sort of n (a power of two, >= 64) 64-bit keys by
// the block, in shared or device memory: a block barrier only before a
// step whose pairs cross a warp's 64-key segment (stride >= 64) and the
// step after one, __syncwarp before the others.
__device__ void block_sort64(uint64_t* keys, int n) {
  int prev_j = n;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 64 || prev_j >= 64)
        __syncthreads();
      else
        __syncwarp();
      prev_j = j;
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int i = 2 * j * (t / j) + (t % j);
        const uint64_t a = keys[i], b = keys[i + j];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
    }
  }
  __syncthreads();
}

// The realtime pool's anchored extremum, kept by one warp: the rows in
// (key, index) order (`ord`; key = completion for the in-pool, minus
// invocation for the out-pool), a window of 32 of them from `base` in
// the lanes' registers (node, value). The pool only shrinks, so the
// first member's position only grows and the window only moves on.
struct Window {
  int base, node, val;
};

__device__ __forceinline__ void load_window(Window& w, int base,
                                            const int32_t* ord,
                                            const int* vals, int N) {
  const int lane = threadIdx.x & 31;
  w.base = base;
  w.node = base + lane < N ? ord[base + lane] : -1;
  w.val = w.node >= 0 ? vals[w.node] : 0;
}

__device__ __forceinline__ bool in_pool(const uint32_t* pool, int node) {
  return node >= 0 && ((pool[node >> 5] >> (node & 31)) & 1u);
}

// The first two pool members in order: (v1, i1, v2) as the reference's
// argmin/argmax over every row computes it, with `big` (the value of a
// row outside the pool: +kBig for the min, -kBig for the max) where
// there is no second member, and (big, 0, big) where every row holds
// big (no member, or the first member's value is big itself).
__device__ Ext pool_extremum(Window& w, const uint32_t* pool,
                             const int32_t* ord, const int* vals, int N,
                             int big) {
  const int lane = threadIdx.x & 31;
  int f = -1, v1 = 0, i1 = 0, v2 = big;
  for (;;) {
    const unsigned b = __ballot_sync(kFull, in_pool(pool, w.node));
    if (b == 0u) {
      if (w.base + 32 >= N) break;
      load_window(w, w.base + 32, ord, vals, N);
      continue;
    }
    f = __ffs(b) - 1;
    if (f > 0) {  // no member before lane f, now or later: move on
      load_window(w, w.base + f, ord, vals, N);
      continue;
    }
    v1 = __shfl_sync(kFull, w.val, 0);
    i1 = __shfl_sync(kFull, w.node, 0);
    const unsigned rest = b & ~1u;
    if (rest) {
      v2 = __shfl_sync(kFull, w.val, __ffs(rest) - 1);
      break;
    }
    // the second member lies past the window: look ahead, not moving it
    for (int t = w.base + 32; t < N; t += 32) {
      const int node = t + lane < N ? ord[t + lane] : -1;
      const unsigned b2 = __ballot_sync(kFull, in_pool(pool, node));
      if (b2) {
        const int l = __ffs(b2) - 1;
        const int n2 = __shfl_sync(kFull, node, l);
        v2 = vals[n2];
        break;
      }
    }
    break;
  }
  if (f < 0 || v1 == big) return {big, 0, big};
  return {v1, i1, v2};
}

// grid (S), block 1024; dynamic shared memory (see elle_trim below): the
// packed counts and the pool bits, then where they fit the segment
// buffers, the lists' ends, the event arrays and the lists' entries
__global__ void __launch_bounds__(kThreads, 1) trim_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Ext thr[2];  // the in-pool's min, the out-pool's max
  __shared__ int red_sum[kWarps];
  __shared__ int part[kWarps];
  __shared__ int last;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = p.n_pad, S = p.S, P = p.p_pad;
  const int npt = (N + kThreads - 1) / kThreads;

  // shared memory, in this order
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);  // in | out << 16
  uint32_t* pool = cnt + N;                           // [2][N / 32]
  uint8_t* at = reinterpret_cast<uint8_t*>(pool + N / 16);
  int* s_seg = reinterpret_cast<int*>(at);
  at += p.seg_smem ? 16 * (size_t)P : 0;
  int* s_ends = reinterpret_cast<int*>(at);
  at += p.ends_smem ? 8 * (size_t)N : 0;
  int* s_ev = reinterpret_cast<int*>(at);
  at += p.ev_smem ? 8 * (size_t)N : 0;
  uint16_t* s_ent = reinterpret_cast<uint16_t*>(at);
  // device scratch, per subset (elle/tpu.py::trim_scratch_words)
  int32_t* sub = p.scratch + p.head_words + (size_t)s * p.sub_words;
  uint64_t* g_keys = reinterpret_cast<uint64_t*>(sub);  // N
  int* g_ends = sub + 2 * N;                            // 2 N
  int32_t* ord = sub + 4 * N;                           // [2][N]
  uint16_t* g_ent = reinterpret_cast<uint16_t*>(sub + 6 * N);
  int* seg = p.seg_smem ? s_seg : sub + p.seg_off;
  // list k (k < N: the in-list transpose of node k, else the out-list
  // transpose of node k - N) spans [k ? ends[k - 1] : 0, ends[k])
  int* ends = p.ends_smem ? s_ends : g_ends;
  uint16_t* ent = p.ent_smem ? s_ent : g_ent;
  const int* ev_inv = p.ev_smem ? s_ev : p.inv;
  const int* ev_comp = p.ev_smem ? s_ev + N : p.comp;

  // ---- prologue: the live and inverted bits, the counts, the
  // transposed lists (`ends` holds the lists' counts, starts, ends)
  uint32_t live = 0u, inverted = 0u;
  for (int m = 0; m < npt; ++m) {
    const int i = tid + m * kThreads;
    if (i >= N) break;
    if (p.live0[(size_t)i * S + s]) live |= 1u << m;
    if (p.comp[i] < p.inv[i]) inverted |= 1u << m;
  }
  for (int k = tid; k < 2 * N; k += kThreads) ends[k] = 0;
  if (p.use_proc)
    for (int q = tid; q < P; q += kThreads) {
      seg[q] = INT_MAX;
      seg[P + q] = INT_MIN;
    }
  __syncthreads();
  for (int m = 0; m < npt; ++m) {
    const int i = tid + m * kThreads;
    if (i >= N) break;
    uint32_t c = 0u;
    const int32_t* nb = p.in_neigh + (size_t)i * p.d_in;
    const uint8_t* mk = p.in_mask + (size_t)i * p.d_in * S + s;
    for (int d = 0; d < p.d_in; ++d)
      if (mk[d * S]) {
        const int j = nb[d];
        atomicAdd(&ends[j], 1);
        c += p.live0[(size_t)j * S + s] != 0;
      }
    nb = p.out_neigh + (size_t)i * p.d_out;
    mk = p.out_mask + (size_t)i * p.d_out * S + s;
    for (int d = 0; d < p.d_out; ++d)
      if (mk[d * S]) {
        const int j = nb[d];
        atomicAdd(&ends[N + j], 1);
        c += p.live0[(size_t)j * S + s] != 0 ? kOutOne : 0u;
      }
    cnt[i] = c;
  }
  __syncthreads();
  block_scan(ends, 2 * N, part);
  for (int m = 0; m < npt; ++m) {
    const int i = tid + m * kThreads;
    if (i >= N) break;
    const int32_t* nb = p.in_neigh + (size_t)i * p.d_in;
    const uint8_t* mk = p.in_mask + (size_t)i * p.d_in * S + s;
    for (int d = 0; d < p.d_in; ++d)
      if (mk[d * S]) ent[atomicAdd(&ends[nb[d]], 1)] = (uint16_t)i;
    nb = p.out_neigh + (size_t)i * p.d_out;
    mk = p.out_mask + (size_t)i * p.d_out * S + s;
    for (int d = 0; d < p.d_out; ++d)
      if (mk[d * S]) ent[atomicAdd(&ends[N + nb[d]], 1)] = (uint16_t)i;
  }
  // the rows in (completion, index) and (-invocation, index) order,
  // sorted where the event arrays go, then the event arrays themselves
  Window win;
  if (p.use_rt) {
    uint64_t* keys = p.ev_smem ? reinterpret_cast<uint64_t*>(s_ev) : g_keys;
    for (int o = 0; o < 2; ++o) {
      __syncthreads();
      for (int i = tid; i < N; i += kThreads) {
        const long long v = o == 0 ? (long long)p.comp[i] + kBig
                                   : (long long)kBig - p.inv[i];
        keys[i] = ((uint64_t)v << 32) | (uint32_t)i;
      }
      block_sort64(keys, N);
      for (int i = tid; i < N; i += kThreads)
        ord[o * N + i] = (int32_t)(keys[i] & 0xFFFFFFFFu);
    }
    __syncthreads();
    if (p.ev_smem)
      for (int k = tid; k < 2 * N; k += kThreads)
        s_ev[k] = k < N ? p.inv[k] : p.comp[k - N];
    __syncthreads();
    if (warp < 2)
      load_window(win, 0, ord + warp * N, warp == 0 ? ev_comp : ev_inv, N);
  }
  __syncthreads();

  // ---- the fixpoint: two peels a body
  int prev = -1, c = 0, body = 0, peel = 0;
  uint32_t pool_words = npt == 32 ? kFull : (1u << npt) - 1u;
  while (body < N) {
    for (int half = 0; half < 2; ++half, ++peel) {
      int* segmin = seg + 2 * (peel & 1) * P;
      int* segmax = segmin + P;
      if (p.use_proc) {
        for (uint32_t x = live; x; x &= x - 1u) {
          const int i = tid + (__ffs(x) - 1) * kThreads;
          atomicMin(&segmin[p.proc[i]], p.ppos[i]);
          atomicMax(&segmax[p.proc[i]], p.ppos[i]);
        }
        __syncthreads();
      }
      // support from the edges (counts) and the process chains; the
      // loops walk the set bits of a thread's words
      uint32_t hi_m = 0u, ho_m = 0u;
      for (uint32_t x = live; x; x &= x - 1u) {
        const int m = __ffs(x) - 1;
        const int i = tid + m * kThreads;
        const uint32_t cw = cnt[i];
        bool hi = (cw & 0xFFFFu) != 0u, ho = (cw >> 16) != 0u;
        if (p.use_proc) {
          const int pp = p.ppos[i], pr = p.proc[i];
          hi = hi || pp > segmin[pr];
          ho = ho || (pp < segmax[pr] && pp >= 0);
        }
        hi_m |= (uint32_t)hi << m;
        ho_m |= (uint32_t)ho << m;
      }
      if (p.use_proc) {  // empty the other buffer for the next peel
        int* o = seg + 2 * ((peel & 1) ^ 1) * P;
        for (int q = tid; q < P; q += kThreads) {
          o[q] = INT_MAX;
          o[P + q] = INT_MIN;
        }
      }
      // the realtime thresholds: the pools' bits (word warp + 32 m holds
      // the nodes tid + 1024 m of a warp), then warps 0 and 1 find the
      // first two members of each from their windows
      if (p.use_rt) {
        // a word once empty stays empty (the pools only shrink): the
        // warp rewrites only the words its last peel left nonempty
        const uint32_t pin = live & (hi_m | inverted);
        const uint32_t pout = live & (ho_m | inverted);
        for (uint32_t x = pool_words; x; x &= x - 1u) {
          const int m = __ffs(x) - 1;
          const unsigned a = __ballot_sync(kFull, (pin >> m) & 1u);
          const unsigned b = __ballot_sync(kFull, (pout >> m) & 1u);
          if (lane == 0 && warp + 32 * m < N / 32) {
            pool[warp + 32 * m] = a;
            pool[N / 32 + warp + 32 * m] = b;
          }
          if (!(a | b)) pool_words &= ~(1u << m);
        }
      }
      // every count of this peel is read before a death decrements one
      // (peel t reads only live_t)
      __syncthreads();
      if (p.use_rt) {
        if (warp < 2) {
          const Ext e = pool_extremum(win, pool + warp * (N / 32),
                                      ord + warp * N,
                                      warp == 0 ? ev_comp : ev_inv, N,
                                      warp == 0 ? kBig : -kBig);
          if (lane == 0) thr[warp] = e;
        }
        __syncthreads();
      }
      // the nodes that die (only a node without edge or process support
      // reads its events); each walks the lists that name it
      uint32_t died = live & ~(hi_m & ho_m);
      if (p.use_rt) {
        const Ext a = thr[0], b = thr[1];
        for (uint32_t x = died; x; x &= x - 1u) {
          const int m = __ffs(x) - 1;
          const int i = tid + m * kThreads;
          if ((((hi_m >> m) & 1u) ||
               ev_inv[i] > (i == a.i1 ? a.v2 : a.v1)) &&
              (((ho_m >> m) & 1u) ||
               ev_comp[i] < (i == b.i1 ? b.v2 : b.v1)))
            died &= ~(1u << m);
        }
      }
      live &= ~died;
      for (uint32_t wd = __reduce_or_sync(kFull, died); wd; wd &= wd - 1u) {
        const int m = __ffs(wd) - 1;
        unsigned dead = __ballot_sync(kFull, (died >> m) & 1u);
        while (dead) {
          const int j = (warp << 5) + __ffs(dead) - 1 + m * kThreads;
          dead &= dead - 1u;
          const int a0 = j ? ends[j - 1] : 0, a1 = ends[j];
          const int b0 = ends[N + j - 1], b1 = ends[N + j];
          for (int e = a0 + lane; e < a1; e += 32) atomicSub(&cnt[ent[e]], 1u);
          for (int e = b0 + lane; e < b1; e += 32)
            atomicSub(&cnt[ent[e]], kOutOne);
        }
      }
      if (half == 1) {
        const int v = __reduce_add_sync(kFull, __popc(live));
        if (lane == 0) red_sum[warp] = v;
      }
      __syncthreads();
    }
    c = __reduce_add_sync(kFull, red_sum[lane]);
    if (tid == 0) p.counts[min(body, p.rows - 1) * S + s] = c;
    ++body;
    if (c == prev) break;
    prev = c;
  }
  // a stable subset repeats its final count in every later body
  for (int r = body + tid; r < p.rows; r += kThreads) p.counts[r * S + s] = c;
  for (int m = 0; m < npt; ++m) {
    const int i = tid + m * kThreads;
    if (i < N) p.live_out[(size_t)i * S + s] = (live >> m) & 1u;
  }

  // the last CTA to finish applies the joint stop: bodies = the max
  // over subsets, counts rows past it zero
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    p.scratch[1 + s] = body;
    __threadfence();
    last = atomicAdd(&p.scratch[0], 1) == S - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int total = 0;
  for (int k = 0; k < S; ++k)
    total = max(total, static_cast<volatile int32_t*>(p.scratch)[1 + k]);
  if (tid == 0) *p.bodies = total;
  for (int r = total + tid; r < p.rows; r += kThreads)
    for (int k = 0; k < S; ++k) p.counts[r * S + k] = 0;
}

// One barrier-and-reduce step of a 1024-thread block, `iters` times: a
// warp sum, the warps' partials in shared memory (two sets, by parity),
// a barrier, every warp summing the partials. chip_smoke.py times it as
// the unit of a dependent chain's floor (a peel or a WGL round is at
// least one such step); no wrapper, no count.
__global__ void __launch_bounds__(kThreads, 1)
    step_probe_kernel(int iters, int32_t* out) {
  __shared__ int part[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = threadIdx.x;
  for (int k = 0; k < iters; ++k) {
    v = __reduce_add_sync(kFull, v);
    if (lane == 0) part[k & 1][warp] = v;
    __syncthreads();
    v = __reduce_add_sync(kFull, part[k & 1][lane]) + k;
  }
  if (threadIdx.x == 0) *out = v;
}

}  // namespace

extern "C" int elle_trim_step_probe(int32_t* out, int iters, void* stream) {
  step_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int elle_trim(const int32_t* in_neigh, const uint8_t* in_mask,
                         const int32_t* out_neigh, const uint8_t* out_mask,
                         const int32_t* inv, const int32_t* comp,
                         const int32_t* proc, const int32_t* ppos,
                         const uint8_t* live0, uint8_t* live_out,
                         int32_t* counts, int32_t* bodies, int32_t* scratch,
                         int n_pad, int d_in, int d_out, int S, int p_pad,
                         int use_rt, int use_proc, int rows, int slots,
                         void* stream) {
  // n_pad: a power of two (the pool bits, the bitonic sort), every
  // node a bit of its thread's word, node ids in 16 bits
  if (n_pad < 128 || (n_pad & (n_pad - 1)) ||
      n_pad > kThreads * kMaxNodesPerThread || n_pad > 65536 || slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{in_neigh, in_mask, out_neigh, out_mask, inv,    comp,
           proc,     ppos,    live0,     live_out, counts, bodies,
           scratch,  n_pad,   d_in,      d_out,    S,      p_pad,
           use_rt,   use_proc, rows};
  const long long N = n_pad;
  p.seg_smem = use_proc && p_pad <= kSmemProcs;
  const long long ent_words = ((long long)slots + 3) / 4 * 2;
  p.head_words = (2LL + S) / 2 * 2;
  p.seg_off = 6 * N + ent_words;
  p.sub_words = p.seg_off + (use_proc && !p.seg_smem ? 4LL * p_pad : 0);
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, trim_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most = optin - static_cast<long long>(fa.sharedSizeBytes);
  // the counts and the pool bits, then by what a peel waits on: the
  // lists' ends (every death), the event arrays (every node without
  // edge support, when the realtime thresholds are on), the entries
  long long smem = 4 * N + N / 4 + (p.seg_smem ? 16LL * p_pad : 0);
  if (smem > most) return static_cast<int>(cudaErrorInvalidValue);
  p.ends_smem = smem + 8 * N <= most;
  smem += p.ends_smem ? 8 * N : 0;
  p.ev_smem = use_rt && smem + 8 * N <= most;
  smem += p.ev_smem ? 8 * N : 0;
  const long long ent_bytes = (2LL * slots + 15) / 16 * 16;
  p.ent_smem = smem + ent_bytes <= most;
  smem += p.ent_smem ? ent_bytes : 0;
  // the dynamic-shared limit is the whole opt-in on every launch (a
  // constant, so launches of other sizes cannot race on it)
  e = cudaFuncSetAttribute(trim_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(most));
  if (e != cudaSuccess) return static_cast<int>(e);
  trim_kernel<<<S, kThreads, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* elle_trim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
