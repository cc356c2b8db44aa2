// wgl_chunk: one chunk of the bool-window WGL linearizability search, for
// Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl.py::_build_search -> chunk_fn (the jitted
// lax.while_loop over round_body, wgl.py:300, jitted by _compiled_search
// at :320). The plain PyTorch version of the same function is
// jepsen_tpu_torch/ops/wgl_bool.py::chunk_ref; the two agree bit for bit
// on all 13 carry leaves.
//
// The carry keeps the reference's layout: the (K, W) and (K, ic) bool
// rows of the frontier and the (B, W), (B, ic) bool rows of the backlog
// are bytes (0/1). Inside the kernel a frontier config is one packed
// row of Cw = 2 + W/32 + ic/32 words,
//     [base, W/32 window words, ic/32 info words, mst]
// which is also the order the reference hashes. The frontier is packed
// at chunk entry and unpacked at exit; a backlog row is unpacked when it
// spills and packed when it refills the frontier.
//
// One round, computing what round_body computes (not its blocks):
//   1. per parent, one warp: its lanes take the W window slots, a warp
//      minimum gives the min return (with the suffix tail);
//   2. one thread per successor row r (R = K*(W + ic): the K*W ok rows
//      parent-major, then the K*ic info rows): legality, and the
//      successor's words streamed through the three FNV hashes. An ok
//      row sets window bit j and renormalizes by "count trailing ones,
//      shift down by t" over the words (a funnel shift across words, in
//      place of the reference's (K, W, W) shift-gather). The checks run
//      cheapest first, and only a legal row is hashed. No successor
//      row is stored. The rows that explore append their key (s0, s1,
//      s2, r) to a dense list (a warp ballot, one shared atomic a warp):
//      n_ex keys, not R;
//   3. the explorers alone are sorted. The reference sorts all R rows
//      stably by (s0, s1, s2), and a row that does not explore carries
//      the all-ones signature, so those rows follow every explorer in r
//      order: an explorer's sorted position (the fourth word of its
//      memo slot) is its rank among the explorers, and the tail never
//      exists here. The one exception is an explorer whose signature is
//      itself all ones: it sorts into that tail at its r. Then it is a
//      duplicate of the tail row before it, unless no row before it is
//      outside the explorers' list; in that case it takes position
//      n_reg (after every other explorer) and is kept. The kernel
//      places it so (`tail` below). Keys are unique by r, so any
//      ascending sort of (s0, s1, s2, r) yields the stable order.
//      n_ex <= 32: one warp sorts in registers with shuffles and then
//      runs the whole rest of the round (dedup, probe, compaction)
//      without a block barrier; else a bitonic sort in shared memory
//      (kSmemKeys keys), in device scratch past that, with a block
//      barrier only where a step crosses a warp's 64-key segment;
//   4. adjacent equal signatures are dropped (the first entry after the
//      explorers, the all-ones tail, can never equal the last explorer);
//   5. up to `probes` rounds of the memo probe by double hashing. In
//      round q a pending row reads slot (s0 + q (s1 | 1)) & (H - 1) once
//      (one 16-byte load): an equal signature marks it seen; an empty
//      slot is claimed. Among the rows claiming one slot the highest
//      sorted position wins (XLA's scatter keeps the last duplicate).
//      The claims of a round are settled in shared memory: in one warp
//      by __match_any_sync, in the block by an open-addressing map from
//      slot to the highest claiming position (a shared atomicMax; two
//      maps, by the round's parity, each cleared by its claimants after
//      the round). The winner writes its slot once. Past kMapSlots / 2
//      unique rows the claims go through the slot's own fourth word in
//      device memory, as before. The loop ends at the first round in
//      which no row is pending (a block vote): later rounds would change
//      nothing. Reads of a round all precede its writes, so every read
//      sees the table as it was at the round's start;
//   6. compaction in sorted order (a scan of `new` over the n_ex keys):
//      the first K survivors go to the next frontier, the rest spill to
//      the backlog at bk_cnt + posn - K (past B: the overflow flag). A
//      survivor's row is rebuilt from its r (parent k, slot j or m);
//   7. the frontier is refilled from the backlog's top, in reverse;
//   8. flags and stats: stats[3] counts memo hits plus the duplicates
//      step 4 dropped, stats[2] the largest legal successor base.
// The chunk runs until found, an empty frontier, `chunk` rounds or
// max_cfg explored configs.
//
// What bounds it. A round's useful traffic is small (the parents' rows,
// the consts they reach, 16 B of memo table per probing row), so like
// the other WGL chunks this one is latency-bound: a chain of dependent
// rounds, each a chain of dependent phases under block barriers, in one
// persistent CTA (a round depends on the last). Few rows explore (a few
// of the headline's 128 a round, ~1,500 of the 16-wave's 32,768 at K
// 256), so the design spends its barriers and memory trips on them
// alone: the sort, the dedup, the probe and the compaction walk n_ex
// keys; at n_ex <= 32 one warp does all four; the frontiers, the keys,
// the probe states and the claim maps sit in shared memory where they
// fit; a probe round costs one read and at most one write a row, and a
// round with nothing pending ends the probe. The block has a warp
// multiple of R threads (at least 128, at most 1024). Each of the two
// input-selected forms wins on its side (chip_smoke.py times them
// against builds without them, in turns, on an H100 80GB HBM3 at 700 W):
// the one-warp round 6.4 against the block's 10.6 µs a round at K 2, the
// shared claim map 8-12% off the fourth word's time at K 64 (W 32) and
// with a full 1024-slot table; the two tie at K 256, where most rounds
// pass 1024 unique rows.
//
// Limits (ops/wgl_bool.py::check_launch raises past them): W and ic are
// multiples of 32, W <= 1024, ic <= 256, probes <= 8, R <= 2^20.
//
// Scratch (int32 words, ops/wgl_bool.py::scratch_layout): the keys
// (4 R_pad, first, so 16-byte aligned), the probe state and claimed slot
// by sorted position (R_pad each), the two packed frontiers (K Cw each)
// and the min-rets (K). Each part is used where its shared copy does not
// fit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinThreads = 128;
constexpr int kSmemKeys = 4096;            // explorers sorted in shared up to
constexpr int kMapSlots = 2048;            // one probe round's claim map
constexpr int kSmemFrontierWords = 12288;  // both frontiers and min-rets
constexpr int32_t kInf = 0x7fffffff;
constexpr uint32_t kOnes = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRefillWords = 256;  // a refill the one warp makes itself

// Two forms a build can switch off (-DWGL_CHUNK_WARP_ROUND=0,
// -DWGL_CHUNK_CLAIM_MAP=0), so that each is timed against the form it
// stands in for on the same inputs (chip_smoke.py builds such copies);
// the library the port loads has both on.
#ifndef WGL_CHUNK_WARP_ROUND
#define WGL_CHUNK_WARP_ROUND 1  // steps 3-6 in one warp at n_ex <= 32
#endif
#ifndef WGL_CHUNK_CLAIM_MAP
#define WGL_CHUNK_CLAIM_MAP 1   // a probe round's claims in a shared map
#endif

enum : uint32_t {
  kUniq = 1u,     // explores and is not an adjacent duplicate
  kPending = 2u,  // still probing
  kSeen = 4u,     // its signature was found in the table
  kClaim = 8u,    // claims an empty slot in this probe round
  kWon = 16u,     // won the claimed slot
};

struct Params {
  const int32_t *inv, *ret, *opc, *suf, *iinv, *iopc, *T;
  int32_t* fr_base;
  uint8_t* fr_win;
  uint8_t* fr_info;
  int32_t* fr_mst;
  int32_t* fr_cnt;
  int32_t* bk_base;
  uint8_t* bk_win;
  uint8_t* bk_info;
  int32_t* bk_mst;
  int32_t* bk_cnt;
  uint4* table;
  uint8_t* flags;
  int32_t* stats;
  int32_t* scratch;
  int n_pad, ic, W, S, O, K, H, B, chunk, probes, n_ok, n_info, max_cfg;
  int Wl, Il, Cw, RW, R, R_pad, key_cap, fr_smem;
};

__device__ __forceinline__ uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 16777619u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Successor row r of the frontier `cur` (packed rows): returns whether it
// is legal and, only when it is, sets its base and passes its Cw words in
// order to emit(n, w). The checks run cheapest first and load a const
// only when the ones before it pass (most rows of a round are illegal).
template <class Emit>
__device__ __forceinline__ bool successor(const Params& p,
                                          const uint32_t* cur,
                                          const int32_t* minret, int fr_cnt,
                                          int r, int& base_s, Emit&& emit) {
  const bool okrow = r < p.RW;
  int k, j = 0, m = 0;
  if (okrow) {
    k = r / p.W;
    j = r - k * p.W;
  } else {
    const int q = r - p.RW;
    k = q / p.ic;
    m = q - k * p.ic;
  }
  if (k >= fr_cnt) return false;  // not a live parent
  const uint32_t* row = cur + (size_t)k * p.Cw;
  const uint32_t* win = row + 1;
  const uint32_t* info = row + 1 + p.Wl;
  const int base = (int)row[0];
  const int mst = clampi((int)row[1 + p.Wl + p.Il], 0, p.S - 1);
  int nst;
  if (okrow) {
    const int pos = base + j;
    if (((win[j >> 5] >> (j & 31)) & 1u) || pos >= p.n_ok) return false;
    const int posc = clampi(pos, 0, p.n_pad - 1);
    if (p.inv[posc] >= minret[k]) return false;
    nst = p.T[mst * p.O + clampi(p.opc[posc], 0, p.O - 1)];
    if (nst < 0) return false;
    // window with bit j set: word l is win[l] | (bit j if l == j / 32)
    auto w2 = [&](int l) -> uint32_t {
      if (l >= p.Wl) return 0u;
      uint32_t v = win[l];
      if (l == (j >> 5)) v |= 1u << (j & 31);
      return v;
    };
    // t = trailing ones: 32 q + r, q the first word that is not full
    int q = 0;
    while (q < p.Wl && w2(q) == kOnes) ++q;
    const int sh = q < p.Wl ? __ffs((int)~w2(q)) - 1 : 0;
    base_s = base + 32 * q + sh;
    emit(0, (uint32_t)base_s);
    for (int l = 0; l < p.Wl; ++l) {
      const uint32_t a = w2(l + q);
      // a 32-bit shift is undefined, not a no-op: sh == 0 takes a alone
      emit(1 + l, sh == 0 ? a : (a >> sh) | (w2(l + q + 1) << (32 - sh)));
    }
    for (int l = 0; l < p.Il; ++l) emit(1 + p.Wl + l, info[l]);
  } else {
    if (((info[m >> 5] >> (m & 31)) & 1u) || m >= p.n_info) return false;
    if (p.iinv[m] >= minret[k]) return false;
    nst = p.T[mst * p.O + clampi(p.iopc[m], 0, p.O - 1)];
    if (nst < 0) return false;
    base_s = base;
    emit(0, (uint32_t)base);
    for (int l = 0; l < p.Wl; ++l) emit(1 + l, win[l]);
    for (int l = 0; l < p.Il; ++l) {
      uint32_t v = info[l];
      if (l == (m >> 5)) v |= 1u << (m & 31);
      emit(1 + p.Wl + l, v);
    }
  }
  emit(1 + p.Wl + p.Il, (uint32_t)nst);
  return true;
}

// 32 bools (bytes) -> one word, bit b from byte b
__device__ __forceinline__ uint32_t pack32(const uint8_t* bytes) {
  const uint32_t* v = reinterpret_cast<const uint32_t*>(bytes);
  uint32_t w = 0u;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t x = v[u];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if ((x >> (8 * c)) & 0xFFu) w |= 1u << (4 * u + c);
  }
  return w;
}

// one word -> 32 bools (bytes)
__device__ __forceinline__ void unpack32(uint32_t w, uint8_t* bytes) {
  uint32_t* v = reinterpret_cast<uint32_t*>(bytes);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    uint32_t x = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) x |= ((w >> (4 * u + c)) & 1u) << (8 * c);
    v[u] = x;
  }
}

// Word n of a packed row -> the bool carry row (base, window bytes, info
// bytes, mst) at row `i` of the given arrays.
__device__ __forceinline__ void store_word(const Params& p, int32_t* base,
                                           uint8_t* win, uint8_t* info,
                                           int32_t* mst, size_t i, int n,
                                           uint32_t w) {
  if (n == 0) {
    base[i] = (int32_t)w;
  } else if (n <= p.Wl) {
    unpack32(w, win + i * p.W + 32 * (n - 1));
  } else if (n <= p.Wl + p.Il) {
    unpack32(w, info + i * p.ic + 32 * (n - 1 - p.Wl));
  } else {
    mst[i] = (int32_t)w;
  }
}

// The inverse: word n of the packed row of bool carry row `i`.
__device__ __forceinline__ uint32_t load_word(const Params& p,
                                              const int32_t* base,
                                              const uint8_t* win,
                                              const uint8_t* info,
                                              const int32_t* mst, size_t i,
                                              int n) {
  if (n == 0) return (uint32_t)base[i];
  if (n <= p.Wl) return pack32(win + i * p.W + 32 * (n - 1));
  if (n <= p.Wl + p.Il) return pack32(info + i * p.ic + 32 * (n - 1 - p.Wl));
  return (uint32_t)mst[i];
}


// ---- sorting the explorers' keys (unique by r) ---------------------------

__device__ __forceinline__ bool key_gt(const uint4& a, const uint4& b) {
  if (a.x != b.x) return a.x > b.x;
  if (a.y != b.y) return a.y > b.y;
  if (a.z != b.z) return a.z > b.z;
  return a.w > b.w;
}

__device__ __forceinline__ bool same_sig(const uint4& a, const uint4& b) {
  return a.x == b.x && a.y == b.y && a.z == b.z;
}

__device__ __forceinline__ uint4 shfl_xor4(const uint4& v, int m) {
  return make_uint4(__shfl_xor_sync(kFull, v.x, m),
                    __shfl_xor_sync(kFull, v.y, m),
                    __shfl_xor_sync(kFull, v.z, m),
                    __shfl_xor_sync(kFull, v.w, m));
}

// Ascending bitonic sort of 32 keys, one a lane, in registers.
__device__ __forceinline__ uint4 warp_sort(uint4 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint4 o = shfl_xor4(v, j);
      // the lower lane of an ascending pair keeps the smaller key
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? key_gt(v, o) : key_gt(o, v)) v = o;
    }
  }
  return v;
}

// Ascending bitonic sort of n (a power of two, >= 64) keys by the block.
// For a step of stride j <= 32 the pairs of one warp's lanes lie in one
// 64-key segment, the same segment at every such step, so the block
// barrier is taken only before a step that crosses segments (j >= 64)
// and before the first step after one; the others take __syncwarp.
__device__ void block_sort(uint4* keys, int n) {
  const int T = blockDim.x;
  int prev_j = n;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 64 || prev_j >= 64)
        __syncthreads();
      else
        __syncwarp();
      prev_j = j;
      for (int t = threadIdx.x; t < (n >> 1); t += T) {
        const int i = 2 * j * (t / j) + (t % j);  // bit j of i is clear
        const int l = i + j;
        const uint4 a = keys[i], b = keys[l];
        if (key_gt(a, b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[l] = a;
        }
      }
    }
  }
  __syncthreads();
}

// the claim map's slot for memo slot idx (Fibonacci hashing)
__device__ __forceinline__ uint32_t map_slot(uint32_t idx) {
  constexpr int kBits = 11;
  static_assert((1 << kBits) == kMapSlots, "map size");
  return (idx * 0x9E3779B1u) >> (32 - kBits);
}

// A survivor at compaction position posn: its row, rebuilt from r, goes
// to the next frontier or spills to the backlog (dropped past B).
__device__ __forceinline__ void emit_row(const Params& p,
                                         const uint32_t* cur,
                                         const int32_t* minret, int fr_cnt,
                                         uint32_t* nxt, int bk_cnt, int r,
                                         int posn) {
  int base_s;
  if (posn < p.K) {
    uint32_t* dst = nxt + (size_t)posn * p.Cw;
    successor(p, cur, minret, fr_cnt, r, base_s,
              [&](int n, uint32_t w) { dst[n] = w; });
  } else {
    const int sidx = bk_cnt + posn - p.K;
    if (sidx < p.B)
      successor(p, cur, minret, fr_cnt, r, base_s, [&](int n, uint32_t w) {
        store_word(p, p.bk_base, p.bk_win, p.bk_info, p.bk_mst, sidx, n, w);
      });
  }
}

// Frontier rows [at, at + take) from the backlog's top (row top - 1
// first), words split over the threads first, first + stride, ...
__device__ __forceinline__ void refill(const Params& p, uint32_t* nxt,
                                       int at, int top, int take, int first,
                                       int stride) {
  for (int i = first; i < take * p.Cw; i += stride) {
    const int k = i / p.Cw, n = i - k * p.Cw;
    nxt[(size_t)(at + k) * p.Cw + n] = load_word(
        p, p.bk_base, p.bk_win, p.bk_info, p.bk_mst, top - 1 - k, n);
  }
}

// The loop's state, in shared memory: the carry's counts, flags and
// stats, and a refill left to the whole block.
struct Loop {
  int fr_cnt, bk_cnt, flags[3], stats[6];
  int take, take_at, take_top;
};

// Steps 7-8, run by the threads [first, first + stride) that finished
// the round (the one warp, or the block): the frontier refilled from
// the backlog's top, in reverse (a refill past `most` words is left to
// the whole block after the round's barrier), then the flags and the
// stats, by thread `first` == 0. `total` rows were new, `hits` were
// memo hits or dropped duplicates.
__device__ __forceinline__ void end_round(const Params& p, Loop& L,
                                          uint32_t* nxt, int fr_cnt,
                                          int bk_cnt, int total, int hits,
                                          int found, int base_max, int first,
                                          int stride, int most) {
  const int nfr = min(total, p.K);
  const int nbk = min(bk_cnt + max(total - p.K, 0), p.B);
  const int take = min(p.K - nfr, nbk);
  const bool now = take * p.Cw <= most;
  if (now) refill(p, nxt, nfr, nbk, take, first, stride);
  if (first == 0) {
    L.flags[0] |= found;
    L.flags[1] |= total > p.K && bk_cnt + total - 1 - p.K >= p.B;
    L.flags[2] = nfr + take == 0;
    L.stats[0] += fr_cnt;
    L.stats[1] += 1;
    L.stats[2] = max(L.stats[2], base_max);
    L.stats[3] += hits;
    L.stats[4] += total;
    L.stats[5] += 1;
    L.fr_cnt = nfr + take;
    L.bk_cnt = nbk - take;
    L.take = now ? 0 : take;
    L.take_at = nfr;
    L.take_top = nbk;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1) wgl_chunk_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Loop L;
  __shared__ int sh_found, sh_base_max, sh_dup_n, sh_uniq_n;
  __shared__ int sh_nreg, sh_tail_first, sh_ones_n, sh_ones_min;
  __shared__ int sh_warp[kMaxWarps], sh_warp_seen[kMaxWarps];
  __shared__ int sh_warp_ex[kMaxWarps];
  __shared__ int sh_tile_total, sh_tile_seen;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int K = p.K, Cw = p.Cw, R = p.R;

  // dynamic shared memory: keys, probe states and slots (key_cap each),
  // the two claim maps, then the frontiers and min-rets where they fit
  uint4* s_keys = reinterpret_cast<uint4*>(smem);
  uint32_t* s_st = reinterpret_cast<uint32_t*>(s_keys + p.key_cap);
  uint32_t* s_slt = s_st + p.key_cap;
  uint32_t* mkey = s_slt + p.key_cap;     // [2][kMapSlots], kOnes = empty
  uint32_t* mval = mkey + 2 * kMapSlots;  // [2][kMapSlots], position + 1
  // device scratch, sized by ops/wgl_bool.py::scratch_layout
  uint4* g_keys = reinterpret_cast<uint4*>(p.scratch);
  uint32_t* g_st =
      reinterpret_cast<uint32_t*>(p.scratch) + 4 * (size_t)p.R_pad;
  uint32_t* g_slt = g_st + p.R_pad;
  uint32_t* fr = p.fr_smem ? mval + 2 * kMapSlots : g_slt + p.R_pad;
  uint32_t* cur = fr;
  uint32_t* nxt = fr + (size_t)K * Cw;
  int32_t* minret = reinterpret_cast<int32_t*>(fr + 2 * (size_t)K * Cw);
  // where step 2 appends the explorers' keys
  uint4* keys_in = R <= p.key_cap ? s_keys : g_keys;
  const uint4 ones4 = make_uint4(kOnes, kOnes, kOnes, kOnes);

  // ---- entry: pack the frontier, empty the claim maps, scalars
  for (int i = tid; i < K * Cw; i += T) {
    const int k = i / Cw, n = i - k * Cw;
    cur[i] = load_word(p, p.fr_base, p.fr_win, p.fr_info, p.fr_mst, k, n);
  }
  for (int i = tid; i < 2 * kMapSlots; i += T) {
    mkey[i] = kOnes;
    mval[i] = 0u;
  }
  if (tid == 0) {
    L.fr_cnt = *p.fr_cnt;
    L.bk_cnt = *p.bk_cnt;
    for (int i = 0; i < 6; ++i) L.stats[i] = p.stats[i];
    L.stats[1] = 0;  // rounds in this chunk
    for (int i = 0; i < 3; ++i) L.flags[i] = p.flags[i] != 0;
    L.take = 0;
  }
  __syncthreads();

  const uint32_t hmask = (uint32_t)(p.H - 1);
  while (!L.flags[0] && L.fr_cnt > 0 && L.stats[1] < p.chunk &&
         L.stats[0] < p.max_cfg) {
    const int fr_cnt = L.fr_cnt;
    const int bk_cnt = L.bk_cnt;

    // ---- 1. per-parent min return, one warp a parent; clear the next
    // frontier and this round's counters
    for (int k = warp; k < K; k += nwarps) {
      const uint32_t* row = cur + (size_t)k * Cw;
      const int base = (int)row[0];
      int32_t mr = kInf;
      for (int j = lane; j < p.W; j += 32) {
        const int pos = base + j;
        if (!((row[1 + (j >> 5)] >> (j & 31)) & 1u) && pos < p.n_ok)
          mr = min(mr, p.ret[clampi(pos, 0, p.n_pad - 1)]);
      }
      mr = __reduce_min_sync(kFull, mr);
      if (lane == 0)
        minret[k] = min(mr, p.suf[clampi(base + p.W, 0, p.n_pad)]);
    }
    for (int i = tid; i < K * Cw; i += T) nxt[i] = 0u;
    if (tid == 0) {
      sh_found = sh_base_max = sh_dup_n = sh_uniq_n = 0;
      sh_nreg = sh_ones_n = 0;
      sh_tail_first = sh_ones_min = kInf;
    }
    __syncthreads();

    // ---- 2. expand: legality and signatures; append the explorers
    bool found = false;
    int bmax = 0, tail_first = kInf, ones_n = 0, ones_min = kInf;
    for (int r0 = 0; r0 < R; r0 += T) {
      const int r = r0 + tid;
      bool reg = false;
      uint32_t h0 = 0x811C9DC5u, h1 = 0x01000193u, h2 = 0xDEADBEEFu;
      if (r < R) {
        int base_s = 0;
        const bool legal = successor(p, cur, minret, fr_cnt, r, base_s,
                                     [&](int, uint32_t w) {
                                       h0 = fnv_step(h0, w);
                                       h1 = fnv_step(h1, w);
                                       h2 = fnv_step(h2, w);
                                     });
        const bool success = legal && base_s >= p.n_ok;
        const bool ex = legal && !success;
        found |= success;
        if (legal) bmax = max(bmax, base_s);
        h0 |= 1u;
        const bool ones = ex && h0 == kOnes && h1 == kOnes && h2 == kOnes;
        reg = ex && !ones;
        if (!reg) tail_first = min(tail_first, r);
        if (ones) {
          ++ones_n;
          ones_min = min(ones_min, r);
        }
      }
      const unsigned b = __ballot_sync(kFull, reg);
      int off = 0;
      if (lane == 0 && b) off = atomicAdd(&sh_nreg, __popc(b));
      off = __shfl_sync(kFull, off, 0);
      if (reg)
        keys_in[off + __popc(b & lt)] = make_uint4(h0, h1, h2, (uint32_t)r);
    }
    found = __reduce_or_sync(kFull, (unsigned)found) != 0u;
    bmax = __reduce_max_sync(kFull, bmax);
    tail_first = __reduce_min_sync(kFull, tail_first);
    ones_n = __reduce_add_sync(kFull, ones_n);
    ones_min = __reduce_min_sync(kFull, ones_min);
    if (lane == 0) {
      if (found) atomicOr(&sh_found, 1);
      atomicMax(&sh_base_max, bmax);
      atomicMin(&sh_tail_first, tail_first);
      if (ones_n) {
        atomicAdd(&sh_ones_n, ones_n);
        atomicMin(&sh_ones_min, ones_min);
      }
    }
    __syncthreads();

    const int n_reg = sh_nreg;
    // the all-ones explorer first among the tail rows (see the note)
    const bool tail = sh_ones_n > 0 && sh_ones_min == sh_tail_first;
    const int n_ex = n_reg + (tail ? 1 : 0);
    const int dup_extra = sh_ones_n - (tail ? 1 : 0);
    const uint4 tail_key =
        make_uint4(kOnes, kOnes, kOnes, (uint32_t)sh_ones_min);

    if (WGL_CHUNK_WARP_ROUND && n_ex <= 32) {
      // ---- 3-6 in one warp: lane i holds sorted position i
      if (warp == 0) {
        uint4 k = ones4;
        if (lane < n_reg)
          k = keys_in[lane];
        else if (tail && lane == n_reg)
          k = tail_key;
        k = warp_sort(k);
        const bool in = lane < n_ex;
        const uint4 pv = make_uint4(__shfl_up_sync(kFull, k.x, 1),
                                    __shfl_up_sync(kFull, k.y, 1),
                                    __shfl_up_sync(kFull, k.z, 1), 0u);
        const bool same = in && lane > 0 && same_sig(k, pv);
        const bool uniq = in && !same;
        bool pending = uniq, seen = false;
        for (int q = 0; q < p.probes; ++q) {
          if (!__any_sync(kFull, pending)) break;
          const uint32_t idx = (k.x + (uint32_t)q * (k.y | 1u)) & hmask;
          bool claim = false;
          if (pending) {
            const uint4 e = p.table[idx];
            if (e.x != 0u) {
              if (same_sig(e, k)) {
                seen = true;
                pending = false;
              }
            } else {
              claim = true;
            }
          }
          // the highest position among a slot's claimants wins it
          const unsigned grp = __match_any_sync(kFull, claim ? idx : kOnes);
          __syncwarp();  // every read of the round before its writes
          if (claim && 31 - __clz((int)grp) == lane) {
            p.table[idx] = make_uint4(k.x, k.y, k.z, (uint32_t)lane);
            pending = false;
          }
          __syncwarp();
        }
        const bool isnew = uniq && !seen;
        const unsigned nb = __ballot_sync(kFull, isnew);
        if (isnew)
          emit_row(p, cur, minret, fr_cnt, nxt, bk_cnt, (int)k.w,
                   __popc(nb & lt));
        const int hits = __popc(__ballot_sync(kFull, seen)) +
                         __popc(__ballot_sync(kFull, same)) + dup_extra;
        end_round(p, L, nxt, fr_cnt, bk_cnt, __popc(nb), hits, sh_found,
                  sh_base_max, lane, 32, kWarpRefillWords);
      }
    } else {
      // ---- 3. sort the explorers: shared memory where they fit
      int npad = 64;
      while (npad < n_ex) npad <<= 1;
      const bool sm = npad <= p.key_cap;
      uint4* keys = sm ? s_keys : g_keys;
      uint32_t* st = sm ? s_st : g_st;
      uint32_t* slt = sm ? s_slt : g_slt;
      if (sm && keys_in != s_keys)
        for (int i = tid; i < n_reg; i += T) s_keys[i] = g_keys[i];
      for (int i = n_reg + tid; i < npad; i += T)
        keys[i] = (tail && i == n_reg) ? tail_key : ones4;
      block_sort(keys, npad);

      // ---- 4. drop adjacent duplicates
      int dup = 0, nu = 0;
      for (int i = tid; i < n_ex; i += T) {
        const bool same = i > 0 && same_sig(keys[i], keys[i - 1]);
        st[i] = same ? 0u : (kUniq | kPending);
        dup += same ? 1 : 0;
        nu += same ? 0 : 1;
      }
      dup = __reduce_add_sync(kFull, dup);
      nu = __reduce_add_sync(kFull, nu);
      if (lane == 0) {
        atomicAdd(&sh_dup_n, dup);
        atomicAdd(&sh_uniq_n, nu);
      }
      __syncthreads();

      // ---- 5. memo probe, claims settled in the shared map while the
      // unique rows fit it at half load, else in the slots' fourth word
      const bool use_map = WGL_CHUNK_CLAIM_MAP && sh_uniq_n <= kMapSlots / 2;
      for (int q = 0; q < p.probes; ++q) {
        bool any = false;
        if (use_map) {
          uint32_t* mk = mkey + (q & 1) * kMapSlots;
          uint32_t* mv = mval + (q & 1) * kMapSlots;
          for (int i = tid; i < n_ex; i += T) {
            uint32_t s = st[i];
            if (!(s & kPending)) continue;
            const uint4 a = keys[i];
            const uint32_t idx = (a.x + (uint32_t)q * (a.y | 1u)) & hmask;
            const uint4 e = p.table[idx];
            if (e.x != 0u) {
              if (same_sig(e, a)) s = (s & ~kPending) | kSeen;
            } else {
              uint32_t h = map_slot(idx);
              for (;;) {
                const uint32_t old = atomicCAS(&mk[h], kOnes, idx);
                if (old == kOnes || old == idx) break;
                h = (h + 1u) & (kMapSlots - 1);
              }
              atomicMax(&mv[h], (uint32_t)i + 1u);
              slt[i] = h;
              s |= kClaim;
            }
            st[i] = s;
          }
          __syncthreads();
          for (int i = tid; i < n_ex; i += T) {
            uint32_t s = st[i];
            if ((s & kClaim) && mv[slt[i]] == (uint32_t)i + 1u) {
              const uint4 a = keys[i];
              const uint32_t idx = (a.x + (uint32_t)q * (a.y | 1u)) & hmask;
              p.table[idx] = make_uint4(a.x, a.y, a.z, (uint32_t)i);
              s &= ~kPending;
              st[i] = s;
            }
            any |= (s & kPending) != 0u;
          }
          any = __syncthreads_or(any) != 0;
          // the claimants empty this round's map for the round after next
          for (int i = tid; i < n_ex; i += T) {
            const uint32_t s = st[i];
            if (s & kClaim) {
              mk[slt[i]] = kOnes;
              mv[slt[i]] = 0u;
              st[i] = s & ~kClaim;
            }
          }
        } else {
          for (int i = tid; i < n_ex; i += T) {
            uint32_t s = st[i];
            if (!(s & kPending)) continue;
            const uint4 a = keys[i];
            const uint32_t idx = (a.x + (uint32_t)q * (a.y | 1u)) & hmask;
            const uint4 e = p.table[idx];
            if (e.x != 0u) {
              if (same_sig(e, a)) s = (s & ~kPending) | kSeen;
            } else {
              s |= kClaim;
              slt[i] = idx;
              p.table[idx].w = 0u;  // claims count from 0 (the slot is empty)
            }
            st[i] = s;
          }
          __syncthreads();
          for (int i = tid; i < n_ex; i += T)
            if (st[i] & kClaim)
              atomicMax(&p.table[slt[i]].w, (unsigned)(i + 1));
          __syncthreads();
          for (int i = tid; i < n_ex; i += T)
            if ((st[i] & kClaim) && p.table[slt[i]].w == (unsigned)(i + 1))
              st[i] |= kWon;
          __syncthreads();
          for (int i = tid; i < n_ex; i += T) {
            uint32_t s = st[i];
            if (s & kWon) {
              const uint4 a = keys[i];
              p.table[slt[i]] = make_uint4(a.x, a.y, a.z, (unsigned)i);
              s &= ~kPending;
            }
            s &= ~(kClaim | kWon);
            st[i] = s;
            any |= (s & kPending) != 0u;
          }
          any = __syncthreads_or(any) != 0;
        }
        if (!any) break;
      }

      // ---- 6. compaction in sorted order: block scan of `new` in tiles
      int total = 0, seen_n = 0;
      for (int t0 = 0; t0 < n_ex; t0 += T) {
        const int i = t0 + tid;
        const uint32_t s = i < n_ex ? st[i] : 0u;
        const bool isnew = (s & kUniq) && !(s & kSeen);
        const unsigned bal = __ballot_sync(kFull, isnew);
        const unsigned sbal = __ballot_sync(kFull, (s & kSeen) != 0u);
        if (lane == 0) {
          sh_warp[warp] = __popc(bal);
          sh_warp_seen[warp] = __popc(sbal);
        }
        __syncthreads();
        if (warp == 0) {
          const int cnt = lane < nwarps ? sh_warp[lane] : 0;
          int incl = cnt;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += y;
          }
          sh_warp_ex[lane] = incl - cnt;
          const int sn = __reduce_add_sync(
              kFull, lane < nwarps ? sh_warp_seen[lane] : 0);
          if (lane == 31) {
            sh_tile_total = incl;
            sh_tile_seen = sn;
          }
        }
        __syncthreads();
        if (isnew)
          emit_row(p, cur, minret, fr_cnt, nxt, bk_cnt, (int)keys[i].w,
                   total + sh_warp_ex[warp] + __popc(bal & lt));
        total += sh_tile_total;
        seen_n += sh_tile_seen;
      }

      // ---- 7-8
      end_round(p, L, nxt, fr_cnt, bk_cnt, total,
                seen_n + sh_dup_n + dup_extra, sh_found, sh_base_max, tid,
                T, INT_MAX);
    }
    __syncthreads();
    // a large refill after the one-warp round goes to the whole block
    if (L.take > 0) {
      refill(p, nxt, L.take_at, L.take_top, L.take, tid, T);
      __syncthreads();
      if (tid == 0) L.take = 0;
    }
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- exit: unpack the frontier; scalars back into the carry
  for (int i = tid; i < K * Cw; i += T) {
    const int k = i / Cw, n = i - k * Cw;
    store_word(p, p.fr_base, p.fr_win, p.fr_info, p.fr_mst, k, n, cur[i]);
  }
  if (tid == 0) {
    *p.fr_cnt = L.fr_cnt;
    *p.bk_cnt = L.bk_cnt;
    for (int i = 0; i < 3; ++i) p.flags[i] = (uint8_t)(L.flags[i] != 0);
    for (int i = 0; i < 6; ++i) p.stats[i] = L.stats[i];
  }
}

}  // namespace

// 21 device pointers (the 7 consts, the 13 carry leaves, the scratch),
// 13 int32 scalars and the stream.
extern "C" int wgl_chunk(const int32_t* inv, const int32_t* ret,
                         const int32_t* opc, const int32_t* suf,
                         const int32_t* iinv, const int32_t* iopc,
                         const int32_t* T, int32_t* fr_base, uint8_t* fr_win,
                         uint8_t* fr_info, int32_t* fr_mst, int32_t* fr_cnt,
                         int32_t* bk_base, uint8_t* bk_win, uint8_t* bk_info,
                         int32_t* bk_mst, int32_t* bk_cnt, int32_t* table,
                         uint8_t* flags, int32_t* stats, int32_t* scratch,
                         int n_pad, int ic, int W, int S, int O, int K, int H,
                         int B, int chunk, int probes, int n_ok, int n_info,
                         int max_cfg, void* stream) {
  Params p;
  p.inv = inv;
  p.ret = ret;
  p.opc = opc;
  p.suf = suf;
  p.iinv = iinv;
  p.iopc = iopc;
  p.T = T;
  p.fr_base = fr_base;
  p.fr_win = fr_win;
  p.fr_info = fr_info;
  p.fr_mst = fr_mst;
  p.fr_cnt = fr_cnt;
  p.bk_base = bk_base;
  p.bk_win = bk_win;
  p.bk_info = bk_info;
  p.bk_mst = bk_mst;
  p.bk_cnt = bk_cnt;
  p.table = reinterpret_cast<uint4*>(table);
  p.flags = flags;
  p.stats = stats;
  p.scratch = scratch;
  p.n_pad = n_pad;
  p.ic = ic;
  p.W = W;
  p.S = S;
  p.O = O;
  p.K = K;
  p.H = H;
  p.B = B;
  p.chunk = chunk;
  p.probes = probes;
  p.n_ok = n_ok;
  p.n_info = n_info;
  p.max_cfg = max_cfg;
  p.Wl = W / 32;
  p.Il = ic / 32;
  p.Cw = 2 + p.Wl + p.Il;
  p.RW = K * W;
  p.R = K * (W + ic);
  p.R_pad = 1;
  while (p.R_pad < p.R) p.R_pad <<= 1;
  p.key_cap = p.R_pad < kSmemKeys ? p.R_pad : kSmemKeys;
  const int fr_words = 2 * K * p.Cw + K;
  p.fr_smem = fr_words <= kSmemFrontierWords;
  const int dyn = 24 * p.key_cap + 16 * kMapSlots +
                  (p.fr_smem ? 4 * fr_words : 0);
  int threads = (p.R + 31) / 32 * 32;
  threads = threads < kMinThreads ? kMinThreads
                                  : threads > kMaxThreads ? kMaxThreads
                                                          : threads;
  // the kernel's dynamic-shared limit is set to the whole opt-in on every
  // launch (a constant, so launches of other sizes cannot race on it)
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, wgl_chunk_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = optin - static_cast<int>(fa.sharedSizeBytes);
  if (dyn > most) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(wgl_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgl_chunk_kernel<<<1, threads, dyn, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgl_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
