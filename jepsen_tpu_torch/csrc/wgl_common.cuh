// wgl_common.cuh: the chunk loop of the WGL linearizability search, for
// Hopper (sm_90a), shared by the narrow (wgl32_chunk.cu, W <= 32) and
// the wide (wgln_chunk.cu, W = 32 L <= 1024) kernels.
//
// A configuration is one packed int32 row
//     [base, L window lanes, mst, Il info words]       (C = 2 + L + Il)
// (the narrow kernel is L = 1). One chunk runs up to `chunk` rounds and
// writes the packed poll summary.
//
// The phases of one round (R = K*(W + ic) successor rows in JAX's
// layout: first the K*W ok-rows row-major, then the K*ic info-rows;
// dead parent rows keep their slots and are processed like live ones,
// because the memo-hit counter of the reference counts them):
//   1. expand and probe: one thread per successor row: legality,
//      successor words, FNV signatures (only the ok-row's window update
//      differs between the layouts: the `Layout` parameter, ok_shift and
//      ok_lane), then the probe slots: `seen`, the first empty slot;
//      rows that insert claim the slot with atomicMax(w3, row + 1).
//   2. resolve: once every row has claimed, the slot's w3 names the
//      winner, the highest claiming row (XLA's scatter keeps the last
//      duplicate); a row that lost its slot to a twin (the winner's
//      signature, read from the winner's scratch, is its own) is seen.
//   3. compact: exclusive scan of `new` in row order; the first K go to
//      the next frontier, the rest spill to the backlog; each winner
//      writes its entry [s0, s1, s2, row] (every row has read its w3).
//   4. settle the next frontier: refill LIFO from the backlog top,
//      zero the dead rows, and each live row's min unlinearized ret
//      (read by the next round's legality test), a row by a team of
//      lanes that read its window's slots side by side where K is small.
//   5. bookkeeping: flags, stats, one occupancy-ring row.
// A row's scratch (its successor words, signatures, insert slot and
// flags) is written and read by the one thread that owns the row, but
// for the winners' signatures, so a round needs four barriers: after
// the claims, after the resolve (the block counts in the grid form; the
// scan's own in one CTA), after the compaction (the refill reads the
// spilled rows) and before the next frontier is read.
//
// Four forms run this loop (the wrappers pick one by shape alone:
// ops/wgl32.py::block_form, ops/wgln.py::solo_form and
// ops/wgln.py::batched_form):
//   * one CTA a search, the round's scratch in device memory
//     (chunk_body<Layout, false>);
//   * one CTA a search, the round's scratch and both frontiers in
//     dynamic shared memory, where they fit (chunk_body<Layout, true>):
//     only the memo table, the backlog, the consts and the outputs stay
//     in device memory;
//   * the grid form (grid_chunk_body<Layout, GridGroup>): one
//     cooperative launch of up to one 1024-thread CTA per SM, for the
//     wide solo search whose round has too many rows for one SM, or too
//     many bytes for its shared memory;
//   * the cluster form (grid_chunk_body<Layout, ClusterGroup>): the same
//     round body on one thread-block cluster of g CTAs a lane, for the
//     wide lane-batched search whose lanes would leave most SMs idle.
// In the last two a group of G CTAs runs one search: CTA b owns the
// contiguous rows [b R / G, (b + 1) R / G), so the survivors' order (the
// blocks' new counts, their exclusive prefix, then each block's
// tile-ordered scan) stays JAX's row order, and the group's barrier
// stands where the one-CTA forms have a block barrier: a hand-written
// grid barrier in device memory, or the cluster's hardware barrier.
// A one-CTA form's block has a warp multiple of threads, at most 1024.
//
// The plain PyTorch versions (ops/wgl32.py::chunk_ref and
// ops/wgln.py::chunk_ref) agree with every form bit for bit on every
// carry leaf and on the summary.
//
// The lane-batched kernels (wgl32_chunk_batched, wgln_chunk_batched)
// run a body once per lane, each lane on its own slice of every array
// (make_lane_params) to its own stop: the one-CTA body in a grid of
// `lanes` CTAs, CTA l on lane l, or (wgln_chunk_batched only) the
// cluster body in a grid of `lanes` clusters of g CTAs, cluster l on
// lane l. Nothing crosses lanes (a one-CTA lane's state is __shared__,
// a cluster's loop state sits in its lane's control words), so a lane
// that stops early is frozen exactly as the JAX package's vmapped
// while_loop freezes it by select.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wgl {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRingRows = 512;
constexpr int kRingCols = 7;
constexpr int kSummaryHead = 11;
constexpr int kMaxProbes = 8;
constexpr int32_t kInf = 0x7fffffff;
// a grid barrier that waits longer than this traps (a launch error)
// instead of hanging the card
constexpr unsigned long long kBarrierLimitNs = 10000000000ULL;  // 10 s

enum : uint32_t {
  kExplore = 1u,   // legal and not a success
  kSeen = 2u,      // signature found by the probe (or twin lost)
  kInsert = 4u,    // explore, unseen, and an empty probe slot exists
  kWon = 8u,       // won the insert slot
  kNew = 16u,      // explore and not seen: survives into the frontier
};

struct Params {
  const int32_t* meta;   // (n_pad + 1, 4): inv, ret, opcode, sufminret
  const int32_t* tk;     // (O * S,): tk[o * S + s] = T[s, o]
  const int32_t* iinv;   // (ic,)
  const int32_t* iopc;   // (ic,)
  int32_t* fr;           // (K, C)
  int32_t* fr_cnt;       // ()
  int32_t* bk;           // (B, C)
  int32_t* bk_cnt;       // ()
  uint4* table;          // (H,) slots of 4 uint32 words
  int32_t* flags;        // (3,): found, overflow, exhausted
  int32_t* stats;        // (6,)
  int32_t* ring;         // (kRingRows, kRingCols)
  int32_t* summary;      // (kSummaryHead + kRingRows * kRingCols,)
  int32_t* scratch;
  int K, W, L, ic, Il, mst, C, H, B, chunk, probes, n_pad, S, n_ok,
      n_info, max_cfg;
};

// int32 words of one round's scratch (ops/wgl32.py::scratch_words):
// successor rows, three signatures, insert slots, row flags, per-parent
// min ret, the second frontier. The shared form adds the first
// frontier's copy after them.
__host__ __device__ inline long long scratch_words(int K, int W, int ic,
                                                   int C) {
  const long long R = static_cast<long long>(K) * (W + ic);
  return R * (C + 5) + K + static_cast<long long>(K) * C;
}

// The round's scratch, carved from `base`.
struct Scratch {
  int32_t* succ;     // (R, C)
  uint32_t* s0;      // (R,)
  uint32_t* s1;
  uint32_t* s2;
  int32_t* ins;      // (R,)
  uint32_t* rflag;   // (R,)
  int32_t* minret;   // (K,)
  int32_t* fr_alt;   // (K, C)
};

__device__ __forceinline__ Scratch carve(int32_t* base, int R, int K,
                                         int C) {
  Scratch s;
  s.succ = base;
  s.s0 = reinterpret_cast<uint32_t*>(base + static_cast<size_t>(R) * C);
  s.s1 = s.s0 + R;
  s.s2 = s.s1 + R;
  s.ins = reinterpret_cast<int32_t*>(s.s2 + R);
  s.rflag = reinterpret_cast<uint32_t*>(s.ins + R);
  s.minret = reinterpret_cast<int32_t*>(s.rflag + R);
  s.fr_alt = s.minret + K;
  return s;
}

__device__ __forceinline__ uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 16777619u;
  return h ^ (h >> 15);
}

// Writes one successor row word by word into scratch and streams each
// word through the three FNV hashes, in row order.
struct RowWriter {
  int32_t* out;
  int n;
  uint32_t h0, h1, h2;
  __device__ explicit RowWriter(int32_t* o)
      : out(o), n(0), h0(0x811C9DC5u), h1(0x01000193u), h2(0xDEADBEEFu) {}
  __device__ __forceinline__ void push(uint32_t w) {
    out[n++] = (int32_t)w;
    h0 = fnv_step(h0, w);
    h1 = fnv_step(h1, w);
    h2 = fnv_step(h2, w);
  }
};

// window slot j of a row: bit j % 32 of lane j / 32
__device__ __forceinline__ bool linearized(const int32_t* row, int j) {
  return ((uint32_t)row[1 + (j >> 5)] >> (j & 31)) & 1u;
}

// ---- the per-row phases, shared by every form ---------------------------

// 1. expand successor row r of the frontier `cur` and probe the memo
// table with it; an inserting row claims its slot's w3. `found` and
// `bmax` take the row's success and legal base.
template <class Layout>
__device__ __forceinline__ void expand_probe(const Params& p,
                                             const int32_t* cur,
                                             const Scratch& s, int r,
                                             int fr_cnt, bool& found,
                                             int& bmax) {
  const int W = p.W, ic = p.ic, C = p.C;
  const int L = Layout::lanes(p);
  const int RW = p.K * W;
  const bool okrow = r < RW;
  int k, j = 0, m = 0;
  if (okrow) {
    k = r / W;
    j = r - k * W;
  } else {
    const int q = r - RW;
    k = q / ic;
    m = q - k * ic;
  }
  const int32_t* row = cur + (size_t)k * C;
  const int base = row[0];
  const int mst = row[p.mst];
  const bool alive = k < fr_cnt;
  const int32_t mr = s.minret[k];
  int nst;
  bool legal;
  RowWriter w(s.succ + (size_t)r * C);
  uint32_t any_lane = 0u;
  int base_s;
  if (okrow) {
    const int pos = base + j;
    const int posc = min(pos, p.n_pad - 1);
    const int32_t inv = p.meta[posc * 4 + 0];
    const int32_t opc = p.meta[posc * 4 + 2];
    nst = p.tk[opc * p.S + mst];
    legal = !linearized(row, j) && pos < p.n_ok && inv < mr && alive &&
            nst >= 0;
    // set bit j, then shift the window right past its t leading
    // linearized slots (t == 32 L drains it)
    const int t = Layout::ok_shift(p, row, j);
    base_s = base + t;
    w.push((uint32_t)base_s);
    for (int l = 0; l < L; ++l) {
      const uint32_t v = Layout::ok_lane(p, row, j, t, l);
      any_lane |= v;
      w.push(v);
    }
  } else {
    const uint32_t iw = (uint32_t)row[p.mst + 1 + (m >> 5)];
    const bool set = (iw >> (m & 31)) & 1u;
    nst = p.tk[p.iopc[m] * p.S + mst];
    legal = !set && m < p.n_info && p.iinv[m] < mr && alive && nst >= 0;
    base_s = base;
    w.push((uint32_t)base_s);
    for (int l = 0; l < L; ++l) {
      const uint32_t v = (uint32_t)row[1 + l];
      any_lane |= v;
      w.push(v);
    }
  }
  w.push((uint32_t)nst);
  for (int i = 0; i < p.Il; ++i) {
    uint32_t v = (uint32_t)row[p.mst + 1 + i];
    if (!okrow && i == (m >> 5)) v |= 1u << (m & 31);
    w.push(v);
  }
  const bool success = legal && base_s >= p.n_ok && any_lane == 0u;
  found |= success;
  if (legal) bmax = max(bmax, base_s);
  const uint32_t a = w.h0 | 1u;  // never 0: 0 marks an empty slot
  const uint32_t b = w.h1, c = w.h2;
  s.s0[r] = a;
  s.s1[r] = b;
  s.s2[r] = c;

  // the probe reads only w0..w2, so other rows' claims do not disturb it
  const uint32_t hmask = (uint32_t)(p.H - 1);
  const uint32_t step = b | 1u;
  uint4 v[kMaxProbes];
#pragma unroll
  for (int q = 0; q < kMaxProbes; ++q)
    if (q < p.probes) v[q] = p.table[(a + (uint32_t)q * step) & hmask];
  bool seen = false;
  int first = -1;
#pragma unroll
  for (int q = 0; q < kMaxProbes; ++q) {
    if (q < p.probes) {
      const bool occ = v[q].x != 0u;
      seen |= occ && v[q].x == a && v[q].y == b && v[q].z == c;
      if (!occ && first < 0) first = q;
    }
  }
  const uint32_t slot = (a + (uint32_t)max(first, 0) * step) & hmask;
  s.ins[r] = (int32_t)slot;
  uint32_t f = (legal && !success) ? kExplore : 0u;
  if (seen) f |= kSeen;
  if ((f & kExplore) && !seen && first >= 0) {
    f |= kInsert;
    atomicMax(&p.table[slot].w, (unsigned)(r + 1));
  }
  s.rflag[r] = f;
}

// 2. once every row has claimed: the slot's w3 names the winner, the
// highest claiming row (XLA's scatter keeps the last duplicate), whose
// entry will be [s0, s1, s2, row]; a row that lost its slot to a twin
// (the winner's signature is its own) is seen. The entry is written in
// write_entry, after every row has read its slot's w3, and no row needs
// to read it back. Returns whether row r is new; `seen_n` counts its
// memo hit.
__device__ __forceinline__ bool resolve_row(const Params& p, const Scratch& s,
                                            int r, int& seen_n) {
  uint32_t f = s.rflag[r];
  bool seen = f & kSeen;
  if (f & kInsert) {
    const int win = (int)p.table[s.ins[r]].w - 1;
    if (win == r)
      f |= kWon;
    else
      seen |= s.s0[win] == s.s0[r] && s.s1[win] == s.s1[r] &&
              s.s2[win] == s.s2[r];
  }
  const bool isnew = (f & kExplore) && !seen;
  if (isnew) f |= kNew;
  s.rflag[r] = f;
  seen_n += seen ? 1 : 0;
  return isnew;
}

// 3. the winner writes its entry
__device__ __forceinline__ void write_entry(const Params& p, const Scratch& s,
                                            int r) {
  if (s.rflag[r] & kWon)
    p.table[s.ins[r]] = make_uint4(s.s0[r], s.s1[r], s.s2[r], (unsigned)r);
}

// 3. survivor r at position posn: the next frontier's first K rows, then
// the backlog after its bk_cnt rows; returns whether the backlog
// overflowed
__device__ __forceinline__ bool place_row(const Params& p, const Scratch& s,
                                          int32_t* nxt, int r, int posn,
                                          int bk_cnt) {
  const int C = p.C;
  const int32_t* src = s.succ + (size_t)r * C;
  if (posn < p.K) {
    int32_t* dst = nxt + (size_t)posn * C;
    for (int i = 0; i < C; ++i) dst[i] = src[i];
    return false;
  }
  const int sidx = bk_cnt + posn - p.K;
  if (sidx >= p.B) return true;
  int32_t* dst = p.bk + (size_t)sidx * C;
  for (int i = 0; i < C; ++i) dst[i] = src[i];
  return false;
}

// 4. rows [0, K) of a frontier, settled by `nt` threads (this one is t),
// each row by a team of g lanes, g the power of two up to 32 that gives
// every row a team (K rows of W slots: a chain of W / g loads a team,
// not W a thread, where K is small): row k is copied from `src(k)` when
// that is not null, zeroed from row `zero_from` on, and minret[k] is
// the min ret of its unlinearized window slots and its tail, for the
// rows below `live` (kInf past them). Teams stay inside a warp and every
// lane of a warp runs the same trips, so the team's shuffles are whole.
template <class Src>
__device__ __forceinline__ void settle_rows(const Params& p, int32_t* rows,
                                            int32_t* minret, int live,
                                            int zero_from, Src src, int t,
                                            int nt) {
  const int K = p.K, C = p.C;
  int g = nt / K;
  g = g >= 32 ? 32 : (g < 1 ? 1 : 1 << (31 - __clz(g)));
  const int sub = t & (g - 1), team = t / g, nteams = nt / g;
  const int first = (t & ~31) / g;  // the warp's first team
  for (int i = 0; first + i * nteams < K; ++i) {
    const int k = team + i * nteams;
    const bool active = k < K, alive = k < live;
    int32_t* dst = rows + (size_t)k * C;
    if (active) {
      const int32_t* from = src(k);
      if (k >= zero_from) {
        for (int j = sub; j < C; j += g) dst[j] = 0;
      } else if (from != nullptr) {
        for (int j = sub; j < C; j += g) dst[j] = from[j];
      }
    }
    __syncwarp();
    int32_t mr = kInf;
    if (active && alive) {
      const int base = dst[0];
      // the tail's sufminret first: it is not on the window loads' chain
      if (sub == 0) mr = p.meta[min(base + p.W, p.n_pad) * 4 + 3];
      for (int j = sub; j < p.W; j += g) {
        const int pos = base + j;
        const int posc = min(pos, p.n_pad - 1);
        if (!linearized(dst, j) && pos < p.n_ok)
          mr = min(mr, p.meta[posc * 4 + 1]);
      }
    }
    for (int off = g >> 1; off; off >>= 1)
      mr = min(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    if (active && sub == 0) minret[k] = mr;
  }
}

// the next frontier once the survivors are placed: refilled LIFO from
// the backlog top (`nbk` rows before the refill), zeroed past the live
// rows
__device__ __forceinline__ void settle_next(const Params& p, int32_t* nxt,
                                            int32_t* minret, int nfr_cnt,
                                            int take, int nbk, int t,
                                            int nt) {
  const int C = p.C;
  const int32_t* bk = p.bk;
  settle_rows(p, nxt, minret, nfr_cnt + take, nfr_cnt + take,
              [=](int k) -> const int32_t* {
                return k >= nfr_cnt
                           ? bk + (size_t)(nbk - 1 - (k - nfr_cnt)) * C
                           : nullptr;
              },
              t, nt);
}

// the chunk's first frontier: copied in from p.fr where `cur` is not
// p.fr (the shared form), every row kept
__device__ __forceinline__ void load_frontier(const Params& p, int32_t* cur,
                                              int32_t* minret, int fr_cnt,
                                              int t, int nt) {
  const int C = p.C;
  const int32_t* fr = p.fr;
  const bool copy = cur != fr;
  settle_rows(p, cur, minret, fr_cnt, p.K,
              [=](int k) -> const int32_t* {
                return copy ? fr + (size_t)k * C : nullptr;
              },
              t, nt);
}

// Exclusive scan of one tile of `isnew` flags, one per thread of the
// block, in thread order: returns the thread's position among the
// tile's new rows; *tile_total gets the tile's count. Two block
// barriers.
__device__ __forceinline__ int tile_scan(bool isnew, int* sh_warp,
                                         int* sh_warp_ex, int* tile_total,
                                         int& total_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, isnew);
  const int pre = __popc(bal & ((1u << lane) - 1u));
  if (lane == 0) sh_warp[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int cnt = lane < nwarps ? sh_warp[lane] : 0;
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    sh_warp_ex[lane] = incl - cnt;
    if (lane == 31) *tile_total = incl;
  }
  __syncthreads();
  total_out = *tile_total;
  return sh_warp_ex[warp] + pre;
}

// ---- one CTA a search (or a lane) ---------------------------------------

// kShared: the round's scratch and both frontiers live in dynamic
// shared memory (4 * (scratch_words + K C) bytes); p.fr is copied in at
// the start and back at the end.
template <class Layout, bool kShared>
__device__ __forceinline__ void chunk_body(const Params& p) {
  __shared__ int sh_fr_cnt, sh_bk_cnt;
  __shared__ int sh_stats[6];
  __shared__ int sh_flags[3];
  __shared__ int sh_found, sh_overflow, sh_base_max, sh_seen_n;
  __shared__ int sh_warp[kMaxWarps];
  __shared__ int sh_warp_ex[kMaxWarps];
  __shared__ int sh_tile_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int K = p.K, C = p.C;
  const int R = K * (p.W + p.ic);

  int32_t* cur;
  Scratch s;
  if constexpr (kShared) {
    extern __shared__ int32_t dyn[];
    s = carve(dyn, R, K, C);
    cur = s.fr_alt + (size_t)K * C;
  } else {
    s = carve(p.scratch, R, K, C);
    cur = p.fr;
  }
  int32_t* nxt = s.fr_alt;

  if (tid == 0) {
    sh_fr_cnt = *p.fr_cnt;
    sh_bk_cnt = *p.bk_cnt;
    for (int i = 0; i < 6; ++i) sh_stats[i] = p.stats[i];
    sh_stats[1] = 0;  // rounds in this chunk
    for (int i = 0; i < 3; ++i) sh_flags[i] = p.flags[i];
    sh_found = 0;
    sh_overflow = 0;
    sh_base_max = 0;
    sh_seen_n = 0;
  }
  // the frontier in (the shared form's copy) and each live row's min ret
  load_frontier(p, cur, s.minret, *p.fr_cnt, tid, nthreads);
  __syncthreads();

  while (!sh_flags[0] && sh_fr_cnt > 0 && sh_stats[1] < p.chunk &&
         sh_stats[0] < p.max_cfg) {
    const int fr_cnt = sh_fr_cnt;
    const int bk_cnt = sh_bk_cnt;

    // ---- 1. expand and probe every successor row
    bool found = false;
    int bmax = 0;
    for (int r = tid; r < R; r += nthreads)
      expand_probe<Layout>(p, cur, s, r, fr_cnt, found, bmax);
    found = __reduce_or_sync(0xffffffffu, (unsigned)found) != 0u;
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if (lane == 0) {
      if (found) atomicOr(&sh_found, 1);
      atomicMax(&sh_base_max, bmax);
    }
    __syncthreads();

    // ---- 2. every row's winner or twin, before any entry is written
    int seen_n = 0;
    for (int r = tid; r < R; r += nthreads) resolve_row(p, s, r, seen_n);

    // ---- 3. compact in tiles of nthreads rows (row r is thread
    // r % nthreads's in every phase); the winners write their entries
    // behind the first tile's barrier
    int total = 0;
    bool overflow = false;
    for (int t0 = 0; t0 < R; t0 += nthreads) {
      const int r = t0 + tid;
      const bool isnew = r < R && (s.rflag[r] & kNew);
      int tile_total;
      const int posn = total + tile_scan(isnew, sh_warp, sh_warp_ex,
                                         &sh_tile_total, tile_total);
      if (r < R) write_entry(p, s, r);
      if (isnew) overflow |= place_row(p, s, nxt, r, posn, bk_cnt);
      total += tile_total;
    }
    seen_n = __reduce_add_sync(0xffffffffu, seen_n);
    if (lane == 0) atomicAdd(&sh_seen_n, seen_n);
    if (overflow) sh_overflow = 1;
    __syncthreads();

    // ---- 4. settle the next frontier
    const int nfr_cnt = min(total, K);
    const int nbk = min(bk_cnt + max(total - K, 0), p.B);
    const int take = min(K - nfr_cnt, nbk);
    settle_next(p, nxt, s.minret, nfr_cnt, take, nbk, tid, nthreads);

    // ---- 5. bookkeeping
    if (tid == 0) {
      const int seen_all = sh_seen_n;
      const int bm = max(sh_stats[2], sh_base_max);
      const int ridx = sh_stats[1];
      const int fr_next = nfr_cnt + take, bk_next = nbk - take;
      sh_flags[0] |= sh_found;
      sh_flags[1] |= sh_overflow;
      sh_flags[2] = fr_next == 0;
      sh_stats[0] += fr_cnt;
      sh_stats[1] += 1;
      sh_stats[2] = bm;
      sh_stats[3] += seen_all;
      sh_stats[4] += total;
      sh_stats[5] += 1;
      if (ridx < kRingRows) {
        int32_t* rr = p.ring + ridx * kRingCols;
        rr[0] = sh_stats[5];
        rr[1] = fr_cnt;
        rr[2] = seen_all;
        rr[3] = total;
        rr[4] = fr_next;
        rr[5] = bk_next;
        rr[6] = bm;
      }
      sh_fr_cnt = fr_next;
      sh_bk_cnt = bk_next;
      sh_found = 0;
      sh_overflow = 0;
      sh_base_max = 0;
      sh_seen_n = 0;
    }
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }

  // ---- write the carry back and the packed summary
  if (cur != p.fr)
    for (int i = tid; i < K * C; i += nthreads) p.fr[i] = cur[i];
  for (int i = tid; i < kRingRows * kRingCols; i += nthreads)
    p.summary[kSummaryHead + i] = p.ring[i];
  if (tid == 0) {
    *p.fr_cnt = sh_fr_cnt;
    *p.bk_cnt = sh_bk_cnt;
    p.summary[0] = sh_fr_cnt;
    for (int i = 0; i < 3; ++i) {
      p.flags[i] = sh_flags[i];
      p.summary[1 + i] = sh_flags[i];
    }
    for (int i = 0; i < 6; ++i) {
      p.stats[i] = sh_stats[i];
      p.summary[4 + i] = sh_stats[i];
    }
    p.summary[10] = sh_bk_cnt;
  }
}

// ---- the grid and cluster forms -----------------------------------------

// Their control words in device memory, after the round's scratch (the
// grid form's kGridCtlWords, which the wrapper reads through
// wgln_chunk_grid_ctl_words; a cluster lane's kClusterCtlWords, which
// ops/wgl32.py::CLUSTER_CTL_WORDS mirrors): the grid barrier's arrive
// counter (zeroed by the entry point before the launch; unused by a
// cluster), the loop state (written by rank 0 before the first barrier
// and in phase 5, read by every block after the round's last barrier),
// two sets of the round's cross-block sums indexed by the round's parity
// (zeroed by rank 0 before the first barrier), and each block's count of
// new rows.
enum : int {
  kBarCount = 0,
  kCtlFrCnt = 2,
  kCtlBkCnt = 3,
  kCtlFlags = 4,   // 3 words
  kCtlStats = 7,   // 6 words
  kCtlSums = 16,   // 2 sets of kSumWords
  kCtlBlocks = 32, // one word a block
};
enum : int { kSumFound = 0, kSumOverflow = 1, kSumBaseMax = 2, kSumSeen = 3,
             kSumWords = 4 };
constexpr int kMaxGridBlocks = 1024;
constexpr int kGridCtlWords = kCtlBlocks + kMaxGridBlocks;
// a cluster of more than 8 CTAs is non-portable; Hopper takes 16
constexpr int kMaxClusterBlocks = 16;
constexpr int kClusterCtlWords = kCtlBlocks + kMaxClusterBlocks;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any leaves; the writes of each
// before its arrival are visible to all after. The arrive counter only
// grows: barrier n of the launch ends when it reaches n G, which every
// block counts in `target` (the counter is zeroed before the launch).
// Thread 0 arrives with a release add and waits with acquire loads,
// the block's barrier on either side (the cooperative launch makes
// every block resident, so the wait ends). A wait past kBarrierLimitNs
// traps.
__device__ __forceinline__ void grid_sync(int32_t* ctl, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(ctl + kBarCount);
    atom_add_release(count, 1u);
    if (ld_acquire(count) < target) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(count) < target)
        if (global_ns() - t0 > kBarrierLimitNs) __trap();
    }
  }
  __syncthreads();
}

// The group of CTAs that runs one search in grid_chunk_body: its size,
// this CTA's rank in it, and a barrier of every thread of the group
// after which each thread sees every write (device or shared memory)
// made before it by any thread of the group.

// the whole cooperative grid, through the grid barrier above
struct GridGroup {
  int32_t* ctl;
  unsigned arrived;  // the barrier's count at its last end
  __device__ explicit GridGroup(int32_t* c) : ctl(c), arrived(0) {}
  __device__ __forceinline__ int size() const { return gridDim.x; }
  __device__ __forceinline__ int rank() const { return blockIdx.x; }
  __device__ __forceinline__ void sync() { grid_sync(ctl, arrived); }
};

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned cluster_id_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

// one thread-block cluster, through the cluster's hardware barrier: every
// thread of every CTA arrives with release and waits with acquire
// semantics at cluster scope, which orders the device-memory writes of
// the cluster's CTAs as well as their shared memory. The hardware
// schedules a cluster's CTAs together, so the wait ends without a
// cooperative launch, and no counter is kept.
struct ClusterGroup {
  __device__ __forceinline__ int size() const {
    return (int)cluster_nctarank();
  }
  __device__ __forceinline__ int rank() const {
    return (int)cluster_ctarank();
  }
  __device__ __forceinline__ void sync() {
    asm volatile(
        "barrier.cluster.arrive.release;\n\t"
        "barrier.cluster.wait.acquire;" ::: "memory");
  }
};

// the sum of `v` over the block (every thread gets it); one barrier
// pair through `sh`
__device__ __forceinline__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += sh[i];
  __syncthreads();
  return t;
}

// One search on a group of G CTAs of blockDim.x threads (Group: the
// GridGroup or the ClusterGroup), its control words at `ctl`.
template <class Layout, class Group>
__device__ __forceinline__ void grid_chunk_body(const Params& p,
                                                int32_t* ctl, Group grp) {
  __shared__ int st_fr_cnt, st_bk_cnt;   // the loop state, from ctl
  __shared__ int st_stats[6];
  __shared__ int st_flags[3];
  __shared__ int sh_found, sh_base_max;
  __shared__ int sh_warp[kMaxWarps];
  __shared__ int sh_warp_ex[kMaxWarps];
  __shared__ int sh_tile_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  const int G = grp.size(), b = grp.rank();
  const int gtid = b * T + tid, gthreads = G * T;
  const int K = p.K, C = p.C;
  const int R = K * (p.W + p.ic);
  const int lo = (int)((long long)b * R / G);
  const int hi = (int)((long long)(b + 1) * R / G);

  Scratch s = carve(p.scratch, R, K, C);
  int32_t* cur = p.fr;
  int32_t* nxt = s.fr_alt;
  volatile int32_t* vctl = ctl;

  if (b == 0 && tid == 0) {
    ctl[kCtlFrCnt] = *p.fr_cnt;
    ctl[kCtlBkCnt] = *p.bk_cnt;
    for (int i = 0; i < 3; ++i) ctl[kCtlFlags + i] = p.flags[i];
    for (int i = 0; i < 6; ++i) ctl[kCtlStats + i] = p.stats[i];
    ctl[kCtlStats + 1] = 0;  // rounds in this chunk
    for (int i = 0; i < 2 * kSumWords; ++i) ctl[kCtlSums + i] = 0;
  }
  // each live row's min ret, over the group
  load_frontier(p, cur, s.minret, *p.fr_cnt, gtid, gthreads);
  grp.sync();

  for (;;) {
    if (tid == 0) {
      st_fr_cnt = vctl[kCtlFrCnt];
      st_bk_cnt = vctl[kCtlBkCnt];
      for (int i = 0; i < 3; ++i) st_flags[i] = vctl[kCtlFlags + i];
      for (int i = 0; i < 6; ++i) st_stats[i] = vctl[kCtlStats + i];
      sh_found = 0;
      sh_base_max = 0;
    }
    __syncthreads();
    if (st_flags[0] || st_fr_cnt <= 0 || st_stats[1] >= p.chunk ||
        st_stats[0] >= p.max_cfg)
      break;
    const int fr_cnt = st_fr_cnt;
    const int bk_cnt = st_bk_cnt;
    int32_t* sums = ctl + kCtlSums + kSumWords * (st_stats[1] & 1);

    // ---- 1. expand and probe this block's rows
    bool found = false;
    int bmax = 0;
    for (int r = lo + tid; r < hi; r += T)
      expand_probe<Layout>(p, cur, s, r, fr_cnt, found, bmax);
    found = __reduce_or_sync(0xffffffffu, (unsigned)found) != 0u;
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if (lane == 0) {
      if (found) atomicOr(&sh_found, 1);
      atomicMax(&sh_base_max, bmax);
    }
    __syncthreads();
    if (tid == 0) {
      if (sh_found) atomicOr(&sums[kSumFound], 1);
      atomicMax(&sums[kSumBaseMax], sh_base_max);
    }
    grp.sync();

    // ---- 2. every row's winner or twin, and this block's new rows
    int nnew = 0, seen_n = 0;
    for (int r = lo + tid; r < hi; r += T)
      nnew += resolve_row(p, s, r, seen_n) ? 1 : 0;
    nnew = block_sum(nnew, sh_warp);
    seen_n = block_sum(seen_n, sh_warp);
    if (tid == 0) {
      vctl[kCtlBlocks + b] = nnew;
      atomicAdd(&sums[kSumSeen], seen_n);
    }
    grp.sync();

    // ---- 3. this block's offset among the survivors, then its rows'
    // tile-ordered scan; the winners write their entries (every block
    // has read its slots' w3)
    int before = 0, all = 0;
    for (int i = tid; i < G; i += T) {
      const int c = vctl[kCtlBlocks + i];
      all += c;
      if (i < b) before += c;
    }
    before = block_sum(before, sh_warp);
    const int total = block_sum(all, sh_warp);
    int run = before;
    bool overflow = false;
    for (int t0 = lo; t0 < hi; t0 += T) {
      const int r = t0 + tid;
      const bool isnew = r < hi && (s.rflag[r] & kNew);
      int tile_total;
      const int posn = run + tile_scan(isnew, sh_warp, sh_warp_ex,
                                       &sh_tile_total, tile_total);
      if (r < hi) write_entry(p, s, r);
      if (isnew) overflow |= place_row(p, s, nxt, r, posn, bk_cnt);
      run += tile_total;
    }
    if (overflow) atomicOr(&sums[kSumOverflow], 1);
    grp.sync();

    // ---- 4. settle the next frontier, over the group
    const int nfr_cnt = min(total, K);
    const int nbk = min(bk_cnt + max(total - K, 0), p.B);
    const int take = min(K - nfr_cnt, nbk);
    settle_next(p, nxt, s.minret, nfr_cnt, take, nbk, gtid, gthreads);

    // ---- 5. bookkeeping, by rank 0; it resets this round's sums
    if (b == 0 && tid == 0) {
      volatile int32_t* vs = sums;
      const int seen_all = vs[kSumSeen];
      const int bm = max(st_stats[2], vs[kSumBaseMax]);
      const int ridx = st_stats[1];
      const int fr_next = nfr_cnt + take, bk_next = nbk - take;
      vctl[kCtlFlags + 0] = st_flags[0] | vs[kSumFound];
      vctl[kCtlFlags + 1] = st_flags[1] | vs[kSumOverflow];
      vctl[kCtlFlags + 2] = fr_next == 0;
      vctl[kCtlStats + 0] = st_stats[0] + fr_cnt;
      vctl[kCtlStats + 1] = st_stats[1] + 1;
      vctl[kCtlStats + 2] = bm;
      vctl[kCtlStats + 3] = st_stats[3] + seen_all;
      vctl[kCtlStats + 4] = st_stats[4] + total;
      vctl[kCtlStats + 5] = st_stats[5] + 1;
      if (ridx < kRingRows) {
        int32_t* rr = p.ring + ridx * kRingCols;
        rr[0] = st_stats[5] + 1;
        rr[1] = fr_cnt;
        rr[2] = seen_all;
        rr[3] = total;
        rr[4] = fr_next;
        rr[5] = bk_next;
        rr[6] = bm;
      }
      vctl[kCtlFrCnt] = fr_next;
      vctl[kCtlBkCnt] = bk_next;
      for (int i = 0; i < kSumWords; ++i) vs[i] = 0;
    }
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    grp.sync();
  }

  // ---- write the carry back and the packed summary, over the group
  if (cur != p.fr)
    for (int i = gtid; i < K * C; i += gthreads) p.fr[i] = cur[i];
  for (int i = gtid; i < kRingRows * kRingCols; i += gthreads)
    p.summary[kSummaryHead + i] = p.ring[i];
  if (b == 0 && tid == 0) {
    *p.fr_cnt = st_fr_cnt;
    *p.bk_cnt = st_bk_cnt;
    p.summary[0] = st_fr_cnt;
    for (int i = 0; i < 3; ++i) {
      p.flags[i] = st_flags[i];
      p.summary[1 + i] = st_flags[i];
    }
    for (int i = 0; i < 6; ++i) {
      p.stats[i] = st_stats[i];
      p.summary[4 + i] = st_stats[i];
    }
    p.summary[10] = st_bk_cnt;
  }
}

// The kernels' shared C interface (ops/_native.py binds it): 14 device
// pointers and 13 int32 scalars (WGL_CHUNK_ARGS), then each entry
// point's launch form (ops/wgl32.py::FORM_FIELDS) and the stream.
__host__ __device__ inline Params make_params(const int32_t* meta, const int32_t* tk,
                          const int32_t* iinv, const int32_t* iopc,
                          int32_t* fr, int32_t* fr_cnt, int32_t* bk,
                          int32_t* bk_cnt, int32_t* table, int32_t* flags,
                          int32_t* stats, int32_t* ring, int32_t* summary,
                          int32_t* scratch, int K, int W, int L, int ic,
                          int H, int B, int chunk, int probes, int n_pad,
                          int S, int n_ok, int n_info, int max_cfg) {
  Params p;
  p.meta = meta;
  p.tk = tk;
  p.iinv = iinv;
  p.iopc = iopc;
  p.fr = fr;
  p.fr_cnt = fr_cnt;
  p.bk = bk;
  p.bk_cnt = bk_cnt;
  p.table = reinterpret_cast<uint4*>(table);
  p.flags = flags;
  p.stats = stats;
  p.ring = ring;
  p.summary = summary;
  p.scratch = scratch;
  p.K = K;
  p.W = W;
  p.L = L;
  p.ic = ic;
  p.Il = ic > 32 ? (ic + 31) / 32 : 1;
  p.mst = 1 + L;
  p.C = 2 + L + p.Il;
  p.H = H;
  p.B = B;
  p.chunk = chunk;
  p.probes = probes;
  p.n_pad = n_pad;
  p.S = S;
  p.n_ok = n_ok;
  p.n_info = n_info;
  p.max_cfg = max_cfg;
  return p;
}

// The lane-batched interface: every array carries a leading lane axis
// (lane l's slice starts at l times the per-lane size) and n_ok, n_info
// and max_cfg are per-lane device int32 arrays. 17 device pointers and
// 12 int32 scalars (WGL_BATCHED_ARGS), then each entry point's launch
// form (ops/wgl32.py::FORM_FIELDS) and the stream.
struct BatchParams {
  const int32_t* meta;     // (lanes, n_pad + 1, 4)
  const int32_t* tk;       // (lanes, O * S)
  const int32_t* iinv;     // (lanes, ic)
  const int32_t* iopc;     // (lanes, ic)
  int32_t* fr;             // (lanes, K, C)
  int32_t* fr_cnt;         // (lanes,)
  int32_t* bk;             // (lanes, B, C)
  int32_t* bk_cnt;         // (lanes,)
  int32_t* table;          // (lanes, H, 4)
  int32_t* flags;          // (lanes, 3)
  int32_t* stats;          // (lanes, 6)
  int32_t* ring;           // (lanes, kRingRows, kRingCols)
  int32_t* summary;        // (lanes, kSummaryHead + kRingRows * kRingCols)
  int32_t* scratch;        // (lanes, scratch words); unused when shared
  const int32_t* n_ok;     // (lanes,)
  const int32_t* n_info;   // (lanes,)
  const int32_t* max_cfg;  // (lanes,)
  int K, W, L, ic, H, B, chunk, probes, n_pad, S, O, lanes;
};

// Lane l's Params: the per-lane strides of every array and lane l's
// scalars (read from device memory, so call it on the device). A lane's
// scratch is scratch_words, and `ctl_words` more where its form keeps
// control words after it (the cluster form).
__device__ inline Params make_lane_params(const BatchParams& b, int l,
                                          int ctl_words = 0) {
  const size_t lz = static_cast<size_t>(l);
  const int Il = b.ic > 32 ? (b.ic + 31) / 32 : 1;
  const int C = 2 + b.L + Il;
  const size_t scratch =
      static_cast<size_t>(scratch_words(b.K, b.W, b.ic, C)) + ctl_words;
  const size_t summary = kSummaryHead + kRingRows * kRingCols;
  return make_params(
      b.meta + lz * (b.n_pad + 1) * 4, b.tk + lz * b.S * b.O,
      b.iinv + lz * b.ic, b.iopc + lz * b.ic, b.fr + lz * b.K * C,
      b.fr_cnt + lz, b.bk + lz * b.B * C, b.bk_cnt + lz,
      b.table + lz * b.H * 4, b.flags + lz * 3, b.stats + lz * 6,
      b.ring + lz * kRingRows * kRingCols, b.summary + lz * summary,
      b.scratch + lz * scratch, b.K, b.W, b.L, b.ic, b.H, b.B, b.chunk,
      b.probes, b.n_pad, b.S, b.n_ok[l], b.n_info[l], b.max_cfg[l]);
}

// One lane per CTA: thread 0 builds the lane's Params in shared memory
// (one read of the per-lane scalars), then the block runs chunk_body.
template <class Layout, bool kShared>
__device__ __forceinline__ void lane_chunk_body(const BatchParams& b) {
  __shared__ Params sp;
  if (threadIdx.x == 0) sp = make_lane_params(b, blockIdx.x);
  __syncthreads();
  chunk_body<Layout, kShared>(sp);
}

// One lane per cluster: every CTA of cluster l builds lane l's Params
// (its scratch followed by its kClusterCtlWords control words), then
// the cluster runs the group body on it.
template <class Layout>
__device__ __forceinline__ void lane_cluster_body(const BatchParams& b) {
  __shared__ Params sp;
  if (threadIdx.x == 0)
    sp = make_lane_params(b, (int)cluster_id_x(), kClusterCtlWords);
  __syncthreads();
  grid_chunk_body<Layout>(
      sp, sp.scratch + scratch_words(sp.K, sp.W, sp.ic, sp.C),
      ClusterGroup());
}

// ---- host side: the launches ---------------------------------------------

// Lets kernel `k` take as much dynamic shared memory as a block of it
// can hold on the current device (the opt-in limit less its static
// bytes), and returns that amount in `most`. The attribute belongs to
// the function for the whole process, so it is set to this one value on
// every call, never to one launch's bytes: launches of the same kernel
// at other sizes on other threads and streams cannot lower it under one
// another.
inline cudaError_t allow_block_smem(const void* k, int* most) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return e;
  *most = optin - static_cast<int>(fa.sharedSizeBytes);
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *most);
}

// The one-CTA kernels of a layout and their launch (`smem` > 0 takes
// the shared form with that many dynamic bytes; more than the block
// holds beside the kernel's static state is refused).
template <class Arg>
inline cudaError_t launch_block(void (*global_k)(Arg), void (*shared_k)(Arg),
                                const Arg& a, int grid, int threads,
                                int smem, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || smem < 0)
    return cudaErrorInvalidValue;
  if (smem > 0) {
    int most = 0;
    const cudaError_t e =
        allow_block_smem(reinterpret_cast<const void*>(shared_k), &most);
    if (e != cudaSuccess) return e;
    if (smem > most) return cudaErrorInvalidValue;
    shared_k<<<grid, threads, smem, stream>>>(a);
  } else {
    global_k<<<grid, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// The grid form's cooperative launch: at most `blocks` blocks of
// kMaxThreads threads, never more than every SM holds at once (the
// occupancy query) nor kMaxGridBlocks. Its control words follow the
// round's scratch and are zeroed on the stream first.
inline cudaError_t launch_grid(void (*grid_k)(Params, int32_t*),
                               const Params& p, int blocks,
                               cudaStream_t stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, grid_k,
                                                      kMaxThreads, 0);
  if (e != cudaSuccess) return e;
  int g = blocks;
  if (g > occ * sms) g = occ * sms;
  if (g > kMaxGridBlocks) g = kMaxGridBlocks;
  if (g < 1) return cudaErrorCooperativeLaunchTooLarge;
  // the barrier's arrive counter (four barriers a round and one more)
  // must not wrap within the launch
  if ((4LL * p.chunk + 1) * g >= (1LL << 32)) return cudaErrorInvalidValue;
  int32_t* ctl = p.scratch + scratch_words(p.K, p.W, p.ic, p.C);
  e = cudaMemsetAsync(ctl, 0, sizeof(int32_t) * kGridCtlWords, stream);
  if (e != cudaSuccess) return e;
  Params pa = p;
  void* args[] = {&pa, &ctl};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_k), dim3(g),
                                  dim3(kMaxThreads), args, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The cluster form's launch: `lanes` clusters of `g` CTAs of kMaxThreads
// threads (g a power of two from 2 to kMaxClusterBlocks; 16 is
// non-portable, and the kernel is allowed it here), cluster l on lane l.
// No cooperative launch: the hardware schedules each cluster whole, and
// clusters that do not fit at once run in a later wave. Each lane's
// control words follow its scratch and are set by the cluster itself. A
// refused launch returns its error; nothing falls back to another form.
inline cudaError_t allow_cluster(const void* k) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

inline cudaLaunchAttribute cluster_dims(int g) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = static_cast<unsigned>(g);
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

inline bool cluster_size_ok(int g) {
  return g >= 2 && g <= kMaxClusterBlocks && (g & (g - 1)) == 0;
}

inline cudaError_t launch_cluster(void (*cluster_k)(BatchParams),
                                  const BatchParams& b, int g,
                                  cudaStream_t stream) {
  if (!cluster_size_ok(g) || b.lanes < 1) return cudaErrorInvalidValue;
  cudaError_t e = allow_cluster(reinterpret_cast<const void*>(cluster_k));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr = cluster_dims(g);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b.lanes * g));
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cluster_k, b);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of `g` CTAs of the cluster kernel the current card
// holds at once (cudaOccupancyMaxActiveClusters), in *out.
inline cudaError_t cluster_capacity(void (*cluster_k)(BatchParams), int g,
                                    int32_t* out) {
  if (!cluster_size_ok(g)) return cudaErrorInvalidValue;
  cudaError_t e = allow_cluster(reinterpret_cast<const void*>(cluster_k));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr = cluster_dims(g);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g));
  cfg.blockDim = dim3(kMaxThreads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, cluster_k, &cfg);
  if (e == cudaSuccess) *out = n;
  return e;
}

}  // namespace wgl

#define WGL_CHUNK_ARGS                                                      \
  const int32_t *meta, const int32_t *tk, const int32_t *iinv,              \
      const int32_t *iopc, int32_t *fr, int32_t *fr_cnt, int32_t *bk,       \
      int32_t *bk_cnt, int32_t *table, int32_t *flags, int32_t *stats,      \
      int32_t *ring, int32_t *summary, int32_t *scratch, int K, int W, int L, \
      int ic, int H, int B, int chunk, int probes, int n_pad, int S,        \
      int n_ok, int n_info, int max_cfg

#define WGL_CHUNK_PARAMS                                                    \
  wgl::make_params(meta, tk, iinv, iopc, fr, fr_cnt, bk, bk_cnt, table,     \
                   flags, stats, ring, summary, scratch, K, W, L, ic, H, B, \
                   chunk, probes, n_pad, S, n_ok, n_info, max_cfg)

#define WGL_BATCHED_ARGS                                                    \
  const int32_t *meta, const int32_t *tk, const int32_t *iinv,              \
      const int32_t *iopc, int32_t *fr, int32_t *fr_cnt, int32_t *bk,       \
      int32_t *bk_cnt, int32_t *table, int32_t *flags, int32_t *stats,      \
      int32_t *ring, int32_t *summary, int32_t *scratch,                    \
      const int32_t *n_ok, const int32_t *n_info, const int32_t *max_cfg,   \
      int K, int W, int L, int ic, int H, int B, int chunk, int probes,     \
      int n_pad, int S, int O, int lanes

#define WGL_BATCHED_PARAMS                                                  \
  wgl::BatchParams {                                                        \
    meta, tk, iinv, iopc, fr, fr_cnt, bk, bk_cnt, table, flags, stats,      \
        ring, summary, scratch, n_ok, n_info, max_cfg, K, W, L, ic, H, B,   \
        chunk, probes, n_pad, S, O, lanes                                   \
  }
