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
//   1. per parent: the min return over the unlinearized window slots and
//      the suffix tail (suf);
//   2. one thread per successor row r (R = K*(W + ic): the K*W ok rows
//      parent-major, then the K*ic info rows): legality, and the
//      successor's words streamed through the three FNV hashes. An ok
//      row sets window bit j and renormalizes by "count trailing ones,
//      shift down by t" over the words (a funnel shift across words, in
//      place of the reference's (K, W, W) shift-gather). No successor
//      row is stored: only its sort key (s0, s1, s2, r); rows that do
//      not explore get all-ones signatures;
//   3. a one-CTA bitonic sort of the keys, compared as unsigned 4-tuples,
//      over R padded to a power of two with all-ones keys. r breaks
//      every tie, so this unstable sort yields exactly the permutation
//      of the reference's stable lax.sort(num_keys=3). The keys live in
//      dynamic shared memory while R_pad * 16 B fits (kMaxSmemSort), in
//      global scratch past it;
//   4. adjacent equal signatures are dropped;
//   5. `probes` rounds of the memo probe by double hashing. In round q a
//      pending row reads slot (s0 + q (s1 | 1)) & (H - 1): an equal
//      signature marks it seen; an empty slot is claimed. Among the rows
//      claiming one slot the highest SORTED position wins (XLA's scatter
//      keeps the last duplicate): claimants zero the slot's w3, then
//      atomicMax(w3, pos + 1), read back, and the winner writes
//      [s0, s1, s2, pos]. This is not wgl_common.cuh's insert, whose
//      contract is one claim per row at its first empty probe slot by
//      parent-major row: here a row claims at most one slot per probe
//      round, the rounds run in order, and a loser probes on;
//   6. compaction in sorted order (a block-wide scan of `new`): the first
//      K survivors go to the next frontier, the rest spill to the
//      backlog at bk_cnt + posn - K (past B: the overflow flag). A
//      survivor's row is rebuilt from its r (parent k, slot j or m);
//   7. the frontier is refilled from the backlog's top, in reverse;
//   8. flags and stats: stats[3] counts memo hits plus the duplicates
//      the sort dropped, stats[2] the largest legal successor base.
// The chunk runs until found, an empty frontier, `chunk` rounds or
// max_cfg explored configs.
//
// What bounds it. A round's useful traffic is small (the parents' rows,
// the consts they reach, 16 B of memo table per probing row), so like
// the other WGL chunks this one is latency-bound: one persistent
// 1024-thread CTA on one SM, with __syncthreads() between the phases.
// The sort adds log2(R_pad) (log2(R_pad) + 1) / 2 barrier-separated
// passes to every round, and past R_pad = 8192 its keys stream through
// L2. Making it fast (a grid-wide sort, keys kept sorted across rounds)
// is later work; this kernel is the simple one that is right.
//
// Limits (ops/wgl_bool.py::check_launch raises past them): W and ic are
// multiples of 32, W <= 1024, ic <= 256, probes <= 8, R <= 2^20.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemSort = 200 * 1024;
constexpr int32_t kInf = 0x7fffffff;
constexpr uint32_t kOnes = 0xFFFFFFFFu;

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
  int Wl, Il, Cw, RW, R, R_pad, smem_sort;
};

__device__ __forceinline__ uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 16777619u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Successor row r of the frontier `cur` (packed rows): returns whether it
// is legal, sets its base, and passes its Cw words in order to emit(n, w).
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
  const uint32_t* row = cur + (size_t)k * p.Cw;
  const uint32_t* win = row + 1;
  const uint32_t* info = row + 1 + p.Wl;
  const int base = (int)row[0];
  const int mst = clampi((int)row[1 + p.Wl + p.Il], 0, p.S - 1);
  const bool alive = k < fr_cnt;
  bool legal;
  int nst;
  if (okrow) {
    const int pos = base + j;
    const int posc = clampi(pos, 0, p.n_pad - 1);
    const bool lin = (win[j >> 5] >> (j & 31)) & 1u;
    nst = p.T[mst * p.O + clampi(p.opc[posc], 0, p.O - 1)];
    legal = !lin && pos < p.n_ok && p.inv[posc] < minret[k] && alive &&
            nst >= 0;
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
    const bool set = (info[m >> 5] >> (m & 31)) & 1u;
    nst = p.T[mst * p.O + clampi(p.iopc[m], 0, p.O - 1)];
    legal = !set && m < p.n_info && p.iinv[m] < minret[k] && alive &&
            nst >= 0;
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
  return legal;
}

__device__ __forceinline__ bool key_gt(const uint4& a, const uint4& b) {
  if (a.x != b.x) return a.x > b.x;
  if (a.y != b.y) return a.y > b.y;
  if (a.z != b.z) return a.z > b.z;
  return a.w > b.w;
}

// Ascending bitonic sort of n (a power of two) keys by the whole block.
__device__ void bitonic_sort(uint4* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int i = 2 * j * (t / j) + (t % j);  // bit j of i is clear
        const int l = i + j;
        const uint4 a = keys[i], b = keys[l];
        if (key_gt(a, b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }
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

__global__ void __launch_bounds__(kThreads, 1) wgl_chunk_kernel(Params p) {
  extern __shared__ uint4 smem_keys[];
  __shared__ int sh_fr_cnt, sh_bk_cnt;
  __shared__ int sh_stats[6];
  __shared__ int sh_flags[3];
  __shared__ int sh_found, sh_overflow, sh_base_max, sh_seen_n, sh_dup_n;
  __shared__ int sh_warp[kWarps];
  __shared__ int sh_warp_ex[kWarps];
  __shared__ int sh_tile_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = p.K, Cw = p.Cw, R = p.R, R_pad = p.R_pad;

  // scratch layout (int32 words), sized by ops/wgl_bool.py::scratch_words;
  // the keys come first so that they are 16-byte aligned
  uint4* keys = p.smem_sort ? smem_keys
                            : reinterpret_cast<uint4*>(p.scratch);
  uint32_t* cur = reinterpret_cast<uint32_t*>(p.scratch) + 4 * (size_t)R_pad;
  uint32_t* nxt = cur + (size_t)K * Cw;
  int32_t* minret = reinterpret_cast<int32_t*>(nxt + (size_t)K * Cw);
  uint32_t* explore = reinterpret_cast<uint32_t*>(minret + K);  // by row
  uint32_t* state = explore + R;                     // by sorted position
  uint32_t* slot = state + R;                        // by sorted position

  // ---- entry: pack the frontier; scalars into shared memory
  for (int i = tid; i < K * Cw; i += kThreads) {
    const int k = i / Cw, n = i - k * Cw;
    cur[i] = load_word(p, p.fr_base, p.fr_win, p.fr_info, p.fr_mst, k, n);
  }
  if (tid == 0) {
    sh_fr_cnt = *p.fr_cnt;
    sh_bk_cnt = *p.bk_cnt;
    for (int i = 0; i < 6; ++i) sh_stats[i] = p.stats[i];
    sh_stats[1] = 0;  // rounds in this chunk
    for (int i = 0; i < 3; ++i) sh_flags[i] = p.flags[i] != 0;
    sh_found = sh_overflow = sh_base_max = sh_seen_n = sh_dup_n = 0;
  }
  __syncthreads();

  const uint32_t hmask = (uint32_t)(p.H - 1);
  while (!sh_flags[0] && sh_fr_cnt > 0 && sh_stats[1] < p.chunk &&
         sh_stats[0] < p.max_cfg) {
    const int fr_cnt = sh_fr_cnt;
    const int bk_cnt = sh_bk_cnt;

    // ---- 1. per-parent min return; clear the next frontier
    for (int k = tid; k < K; k += kThreads) {
      const uint32_t* row = cur + (size_t)k * Cw;
      const int base = (int)row[0];
      int32_t mr = kInf;
      for (int j = 0; j < p.W; ++j) {
        const int pos = base + j;
        if (!((row[1 + (j >> 5)] >> (j & 31)) & 1u) && pos < p.n_ok)
          mr = min(mr, p.ret[clampi(pos, 0, p.n_pad - 1)]);
      }
      minret[k] = min(mr, p.suf[clampi(base + p.W, 0, p.n_pad)]);
    }
    for (int i = tid; i < K * Cw; i += kThreads) nxt[i] = 0u;
    __syncthreads();

    // ---- 2. expand: legality and the signatures of every row
    bool found = false;
    int bmax = 0;
    for (int r = tid; r < R_pad; r += kThreads) {
      if (r >= R) {
        keys[r] = make_uint4(kOnes, kOnes, kOnes, kOnes);
        continue;
      }
      uint32_t h0 = 0x811C9DC5u, h1 = 0x01000193u, h2 = 0xDEADBEEFu;
      int base_s;
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
      keys[r] = ex ? make_uint4(h0 | 1u, h1, h2, (uint32_t)r)
                   : make_uint4(kOnes, kOnes, kOnes, (uint32_t)r);
      explore[r] = ex ? 1u : 0u;
    }
    found = __reduce_or_sync(0xffffffffu, (unsigned)found) != 0u;
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if (lane == 0) {
      if (found) atomicOr(&sh_found, 1);
      atomicMax(&sh_base_max, bmax);
    }
    __syncthreads();

    // ---- 3. sort
    bitonic_sort(keys, R_pad);

    // ---- 4. drop adjacent duplicates
    int dup = 0;
    for (int i = tid; i < R; i += kThreads) {
      const uint4 a = keys[i];
      bool same = false;
      if (i > 0) {
        const uint4 b = keys[i - 1];
        same = a.x == b.x && a.y == b.y && a.z == b.z;
      }
      const bool ex = explore[a.w] != 0u;
      state[i] = (ex && !same) ? (kUniq | kPending) : 0u;
      dup += (ex && same) ? 1 : 0;
    }
    dup = __reduce_add_sync(0xffffffffu, dup);
    if (lane == 0) atomicAdd(&sh_dup_n, dup);
    __syncthreads();

    // ---- 5. memo probe by double hashing, `probes` rounds in order
    for (int q = 0; q < p.probes; ++q) {
      for (int i = tid; i < R; i += kThreads) {
        uint32_t st = state[i];
        if (!(st & kPending)) continue;
        const uint4 a = keys[i];
        const uint32_t idx = (a.x + (uint32_t)q * (a.y | 1u)) & hmask;
        const uint32_t w0 = p.table[idx].x, w1 = p.table[idx].y,
                       w2 = p.table[idx].z;
        if (w0 != 0u) {
          if (w0 == a.x && w1 == a.y && w2 == a.z)
            st = (st & ~kPending) | kSeen;
        } else {
          st |= kClaim;
          slot[i] = idx;
          p.table[idx].w = 0u;  // claims count from 0 (the slot is empty)
        }
        state[i] = st;
      }
      __syncthreads();
      for (int i = tid; i < R; i += kThreads)
        if (state[i] & kClaim) atomicMax(&p.table[slot[i]].w, (unsigned)(i + 1));
      __syncthreads();
      for (int i = tid; i < R; i += kThreads)
        if ((state[i] & kClaim) && p.table[slot[i]].w == (unsigned)(i + 1))
          state[i] |= kWon;
      __syncthreads();
      for (int i = tid; i < R; i += kThreads) {
        uint32_t st = state[i];
        if (!(st & kClaim)) continue;
        if (st & kWon) {
          const uint4 a = keys[i];
          p.table[slot[i]] = make_uint4(a.x, a.y, a.z, (unsigned)i);
          st &= ~kPending;
        }
        state[i] = st & ~(kClaim | kWon);
      }
      __syncthreads();
    }

    // ---- 6. compaction in sorted order: block scan of `new` in tiles
    int total = 0;
    int seen_n = 0;
    for (int t0 = 0; t0 < R; t0 += kThreads) {
      const int i = t0 + tid;
      const uint32_t st = i < R ? state[i] : 0u;
      const bool isnew = (st & kUniq) && !(st & kSeen);
      seen_n += (st & kSeen) ? 1 : 0;
      const unsigned bal = __ballot_sync(0xffffffffu, isnew);
      const int pre = __popc(bal & ((1u << lane) - 1u));
      if (lane == 0) sh_warp[warp] = __popc(bal);
      __syncthreads();
      if (warp == 0) {
        const int cnt = sh_warp[lane];
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        sh_warp_ex[lane] = incl - cnt;
        if (lane == 31) sh_tile_total = incl;
      }
      __syncthreads();
      if (isnew) {
        const int posn = total + sh_warp_ex[warp] + pre;
        const int r = (int)keys[i].w;
        int base_s;
        if (posn < K) {
          uint32_t* dst = nxt + (size_t)posn * Cw;
          successor(p, cur, minret, fr_cnt, r, base_s,
                    [&](int n, uint32_t w) { dst[n] = w; });
        } else {
          const int sidx = bk_cnt + posn - K;
          if (sidx >= p.B) {
            sh_overflow = 1;
          } else {
            successor(p, cur, minret, fr_cnt, r, base_s,
                      [&](int n, uint32_t w) {
                        store_word(p, p.bk_base, p.bk_win, p.bk_info,
                                   p.bk_mst, sidx, n, w);
                      });
          }
        }
      }
      total += sh_tile_total;
    }
    seen_n = __reduce_add_sync(0xffffffffu, seen_n);
    if (lane == 0) atomicAdd(&sh_seen_n, seen_n);

    // ---- 7. refill the frontier from the backlog top, in reverse
    int nfr_cnt = min(total, K);
    int nbk_cnt = min(bk_cnt + max(total - K, 0), p.B);
    const int take = min(K - nfr_cnt, nbk_cnt);
    for (int i = tid; i < take * Cw; i += kThreads) {
      const int k = i / Cw, n = i - k * Cw;
      nxt[(size_t)(nfr_cnt + k) * Cw + n] = load_word(
          p, p.bk_base, p.bk_win, p.bk_info, p.bk_mst, nbk_cnt - 1 - k, n);
    }
    nfr_cnt += take;
    nbk_cnt -= take;
    __syncthreads();

    // ---- 8. flags and stats
    if (tid == 0) {
      sh_flags[0] |= sh_found;
      sh_flags[1] |= sh_overflow;
      sh_flags[2] = nfr_cnt == 0;
      sh_stats[0] += fr_cnt;
      sh_stats[1] += 1;
      sh_stats[2] = max(sh_stats[2], sh_base_max);
      sh_stats[3] += sh_seen_n + sh_dup_n;
      sh_stats[4] += total;
      sh_stats[5] += 1;
      sh_fr_cnt = nfr_cnt;
      sh_bk_cnt = nbk_cnt;
      sh_found = sh_overflow = sh_base_max = sh_seen_n = sh_dup_n = 0;
    }
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }

  // ---- exit: unpack the frontier; scalars back into the carry
  for (int i = tid; i < K * Cw; i += kThreads) {
    const int k = i / Cw, n = i - k * Cw;
    store_word(p, p.fr_base, p.fr_win, p.fr_info, p.fr_mst, k, n, cur[i]);
  }
  if (tid == 0) {
    *p.fr_cnt = sh_fr_cnt;
    *p.bk_cnt = sh_bk_cnt;
    for (int i = 0; i < 3; ++i) p.flags[i] = (uint8_t)(sh_flags[i] != 0);
    for (int i = 0; i < 6; ++i) p.stats[i] = sh_stats[i];
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
  const size_t smem = (size_t)p.R_pad * sizeof(uint4);
  p.smem_sort = smem <= (size_t)kMaxSmemSort;
  const size_t dyn = p.smem_sort ? smem : 0;
  cudaError_t err = cudaFuncSetAttribute(
      wgl_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgl_chunk_kernel<<<1, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgl_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
