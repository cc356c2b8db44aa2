// wgl32_chunk: one chunk of the narrow-window (W <= 32) WGL
// linearizability search, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl32.py::_build_search32 -> chunk_fn (the
// jitted lax.while_loop over round_body) with its host-layout semantics:
// depth=1, compact=False, accel=False. The plain PyTorch version of the
// same function is jepsen_tpu_torch/ops/wgl32.py::chunk_ref; the two
// agree bit for bit on every carry leaf and on the packed summary.
//
// What bounds it. A round is a chain of dependent steps: read the
// frontier and op metadata, expand and hash, probe the memo table (a
// random 16-byte read per probe into a table of 2^23 slots = 128 MB at
// the 10k-op headline, far past the 50 MB L2), claim and write the
// insert slot, read it back to verify, compact, then spill to and refill
// from the backlog. That is about five dependent global-memory round
// trips per round, and the next round cannot start before this one
// ends. At the headline's beam (K = 2..16 rows, R = K*(W+ic) = 80..640
// successor rows) the bytes per round are a few tens of KB, so the
// round is latency-bound, not bandwidth- or compute-bound.
//
// What this design does about it: one persistent CTA of 1024 threads
// runs the whole round loop of a chunk on the device, with
// __syncthreads() between phases, so a chunk is one launch and no
// round pays a launch or a host round trip. One block keeps JAX's row
// order deterministic (the compaction order is a block-wide prefix sum
// over all R rows) and nothing has to cross blocks. At K = 512 (R =
// 20,480) the block loops over its rows. A grid-wide design
// (cooperative groups, memo insert by 128-bit CAS) and CUDA graphs over
// chunk launches are later work.
//
// The phases of one round (R rows in JAX's layout: first the K*W
// ok-rows row-major, then the K*ic info-rows; dead parent rows keep
// their slots and are processed like live ones, because the memo-hit
// counter of the reference counts them):
//   1. expand: per-parent min unlinearized ret, then one thread per
//      successor row: legality, successor words, FNV signatures.
//   2. probe: read the probe slots; `seen`, the first empty slot; rows
//      that insert claim the slot with atomicMax(w3, row + 1).
//   3. insert: the row that won (the highest, as XLA's scatter keeps
//      the last duplicate) writes [s0, s1, s2, row].
//   4. verify: a twin that lost the slot to the same signature is seen.
//   5. compact: block-wide exclusive scan of `new`; the first K go to
//      the next frontier, the rest spill to the backlog.
//   6. refill LIFO from the backlog top.
//   7. bookkeeping: flags, stats, one occupancy-ring row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRingRows = 512;
constexpr int kRingCols = 7;
constexpr int kSummaryHead = 11;
constexpr int kMaxProbes = 8;
constexpr int32_t kInf = 0x7fffffff;

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
  int K, W, ic, Il, C, H, B, chunk, probes, n_pad, S, n_ok, n_info,
      max_cfg;
};

__device__ __forceinline__ uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * 16777619u;
  return h ^ (h >> 15);
}

__global__ void __launch_bounds__(kThreads, 1)
wgl32_chunk_kernel(Params p) {
  __shared__ int sh_fr_cnt, sh_bk_cnt;
  __shared__ int sh_stats[6];
  __shared__ int sh_flags[3];
  __shared__ int sh_found, sh_overflow, sh_base_max, sh_seen_n;
  __shared__ int sh_warp[kWarps];
  __shared__ int sh_warp_ex[kWarps];
  __shared__ int sh_tile_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = p.K, W = p.W, ic = p.ic, C = p.C, Il = p.Il;
  const int RW = K * W;
  const int R = RW + K * ic;

  // scratch layout (int32 words), sized by ops/wgl32.py::scratch_words
  int32_t* succ = p.scratch;                                    // R * C
  uint32_t* s0 = reinterpret_cast<uint32_t*>(succ + (size_t)R * C);
  uint32_t* s1 = s0 + R;
  uint32_t* s2 = s1 + R;
  int32_t* ins = reinterpret_cast<int32_t*>(s2 + R);            // R
  uint32_t* rflag = reinterpret_cast<uint32_t*>(ins + R);       // R
  int32_t* minret = reinterpret_cast<int32_t*>(rflag + R);      // K
  int32_t* fr_alt = minret + K;                                 // K * C

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
  __syncthreads();

  int32_t* cur = p.fr;
  int32_t* nxt = fr_alt;
  const uint32_t hmask = (uint32_t)(p.H - 1);

  while (!sh_flags[0] && sh_fr_cnt > 0 && sh_stats[1] < p.chunk &&
         sh_stats[0] < p.max_cfg) {
    const int fr_cnt = sh_fr_cnt;
    const int bk_cnt = sh_bk_cnt;

    // ---- 1a. per-parent min unlinearized ret; clear the next frontier
    for (int k = tid; k < K; k += kThreads) {
      const int32_t* row = cur + (size_t)k * C;
      const int base = row[0];
      const uint32_t win = (uint32_t)row[1];
      int32_t mr = kInf;
      for (int j = 0; j < W; ++j) {
        const int pos = base + j;
        const int posc = min(pos, p.n_pad - 1);
        const bool lin = (win >> j) & 1u;
        if (!lin && pos < p.n_ok) mr = min(mr, p.meta[posc * 4 + 1]);
      }
      const int tailp = min(base + W, p.n_pad);
      minret[k] = min(mr, p.meta[tailp * 4 + 3]);
    }
    for (int i = tid; i < K * C; i += kThreads) nxt[i] = 0;
    __syncthreads();

    // ---- 1b. expand every successor row
    bool found = false;
    int bmax = 0;
    for (int r = tid; r < R; r += kThreads) {
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
      const uint32_t win = (uint32_t)row[1];
      const int mst = row[2];
      const bool alive = k < fr_cnt;
      const int32_t mr = minret[k];
      int nst, base_s;
      uint32_t win_s;
      bool legal;
      if (okrow) {
        const int pos = base + j;
        const int posc = min(pos, p.n_pad - 1);
        const bool lin = (win >> j) & 1u;
        const int32_t inv = p.meta[posc * 4 + 0];
        const int32_t opc = p.meta[posc * 4 + 2];
        nst = p.tk[opc * p.S + mst];
        legal = !lin && pos < p.n_ok && inv < mr && alive && nst >= 0;
        const uint32_t wok = win | (1u << j);
        const uint32_t x = ~wok;                  // trailing ones of wok
        const int t = x ? (__ffs((int)x) - 1) : 32;
        win_s = t >= 32 ? 0u : (wok >> t);        // t == 32: drained
        base_s = base + t;
      } else {
        const uint32_t iw = (uint32_t)row[3 + (m >> 5)];
        const bool set = (iw >> (m & 31)) & 1u;
        nst = p.tk[p.iopc[m] * p.S + mst];
        legal = !set && m < p.n_info && p.iinv[m] < mr && alive && nst >= 0;
        win_s = win;
        base_s = base;
      }
      const bool success = legal && base_s >= p.n_ok && win_s == 0u;
      found |= success;
      if (legal) bmax = max(bmax, base_s);

      uint32_t h0 = 0x811C9DC5u, h1 = 0x01000193u, h2 = 0xDEADBEEFu;
      const uint32_t w0 = (uint32_t)base_s, w2 = (uint32_t)nst;
      h0 = fnv_step(fnv_step(fnv_step(h0, w0), win_s), w2);
      h1 = fnv_step(fnv_step(fnv_step(h1, w0), win_s), w2);
      h2 = fnv_step(fnv_step(fnv_step(h2, w0), win_s), w2);
      int32_t* out = succ + (size_t)r * C;
      out[0] = base_s;
      out[1] = (int32_t)win_s;
      out[2] = nst;
      for (int i = 0; i < Il; ++i) {
        uint32_t w = (uint32_t)row[3 + i];
        if (!okrow && i == (m >> 5)) w |= 1u << (m & 31);
        out[3 + i] = (int32_t)w;
        h0 = fnv_step(h0, w);
        h1 = fnv_step(h1, w);
        h2 = fnv_step(h2, w);
      }
      s0[r] = h0 | 1u;  // never 0: 0 marks an empty slot
      s1[r] = h1;
      s2[r] = h2;
      rflag[r] = (legal && !success) ? kExplore : 0u;
    }
    found = __reduce_or_sync(0xffffffffu, (unsigned)found) != 0u;
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if (lane == 0) {
      if (found) atomicOr(&sh_found, 1);
      atomicMax(&sh_base_max, bmax);
    }
    __syncthreads();

    // ---- 2. probe; inserting rows claim their slot's w3 (the probe
    // reads only w0..w2, so claims do not disturb other rows' probes)
    for (int r = tid; r < R; r += kThreads) {
      const uint32_t a = s0[r], b = s1[r], c = s2[r];
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
      ins[r] = (int32_t)slot;
      uint32_t f = rflag[r];
      if (seen) f |= kSeen;
      if ((f & kExplore) && !seen && first >= 0) {
        f |= kInsert;
        atomicMax(&p.table[slot].w, (unsigned)(r + 1));
      }
      rflag[r] = f;
    }
    __syncthreads();

    // ---- 3. the highest claiming row owns the slot ...
    for (int r = tid; r < R; r += kThreads) {
      const uint32_t f = rflag[r];
      if ((f & kInsert) && p.table[ins[r]].w == (unsigned)(r + 1))
        rflag[r] = f | kWon;
    }
    __syncthreads();
    // ... and writes its entry
    for (int r = tid; r < R; r += kThreads) {
      if (rflag[r] & kWon)
        p.table[ins[r]] = make_uint4(s0[r], s1[r], s2[r], (unsigned)r);
    }
    __syncthreads();

    // ---- 4. verify: a twin that lost its slot to the same signature
    int seen_n = 0;
    for (int r = tid; r < R; r += kThreads) {
      uint32_t f = rflag[r];
      bool seen = f & kSeen;
      if (f & kInsert) {
        const uint4 v = p.table[ins[r]];
        seen |= v.x == s0[r] && v.y == s1[r] && v.z == s2[r] &&
                v.w != (unsigned)r;
      }
      if ((f & kExplore) && !seen) f |= kNew;
      rflag[r] = f;
      seen_n += seen ? 1 : 0;
    }
    seen_n = __reduce_add_sync(0xffffffffu, seen_n);
    if (lane == 0) atomicAdd(&sh_seen_n, seen_n);
    __syncthreads();

    // ---- 5. compact: exclusive scan of `new` in tiles of kThreads rows
    int total = 0;
    for (int t0 = 0; t0 < R; t0 += kThreads) {
      const int r = t0 + tid;
      const bool isnew = r < R && (rflag[r] & kNew);
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
        const int32_t* src = succ + (size_t)r * C;
        if (posn < K) {
          int32_t* dst = nxt + (size_t)posn * C;
          for (int i = 0; i < C; ++i) dst[i] = src[i];
        } else {
          const int sidx = bk_cnt + posn - K;
          if (sidx >= p.B) {
            sh_overflow = 1;
          } else {
            int32_t* dst = p.bk + (size_t)sidx * C;
            for (int i = 0; i < C; ++i) dst[i] = src[i];
          }
        }
      }
      total += sh_tile_total;
    }
    __syncthreads();

    // ---- 6. refill the frontier LIFO from the backlog top
    int nfr_cnt = min(total, K);
    int nbk_cnt = min(bk_cnt + max(total - K, 0), p.B);
    const int take = min(K - nfr_cnt, nbk_cnt);
    for (int i = tid; i < take * C; i += kThreads) {
      const int k = i / C, c = i - k * C;
      nxt[(size_t)(nfr_cnt + k) * C + c] =
          p.bk[(size_t)(nbk_cnt - 1 - k) * C + c];
    }
    nfr_cnt += take;
    nbk_cnt -= take;

    // ---- 7. bookkeeping
    if (tid == 0) {
      const int seen_all = sh_seen_n;
      const int bm = max(sh_stats[2], sh_base_max);
      const int ridx = sh_stats[1];
      sh_flags[0] |= sh_found;
      sh_flags[1] |= sh_overflow;
      sh_flags[2] = nfr_cnt == 0;
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
        rr[4] = nfr_cnt;
        rr[5] = nbk_cnt;
        rr[6] = bm;
      }
      sh_fr_cnt = nfr_cnt;
      sh_bk_cnt = nbk_cnt;
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
    for (int i = tid; i < K * C; i += kThreads) p.fr[i] = cur[i];
  for (int i = tid; i < kRingRows * kRingCols; i += kThreads)
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

}  // namespace

extern "C" int wgl32_chunk(
    const int32_t* meta, const int32_t* tk, const int32_t* iinv,
    const int32_t* iopc, int32_t* fr, int32_t* fr_cnt, int32_t* bk,
    int32_t* bk_cnt, int32_t* table, int32_t* flags, int32_t* stats,
    int32_t* ring, int32_t* summary, int32_t* scratch, int K, int W, int ic,
    int H, int B, int chunk, int probes, int n_pad, int S, int n_ok,
    int n_info, int max_cfg, void* stream) {
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
  p.ic = ic;
  p.Il = ic > 32 ? (ic + 31) / 32 : 1;
  p.C = 3 + p.Il;
  p.H = H;
  p.B = B;
  p.chunk = chunk;
  p.probes = probes;
  p.n_pad = n_pad;
  p.S = S;
  p.n_ok = n_ok;
  p.n_info = n_info;
  p.max_cfg = max_cfg;
  wgl32_chunk_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wgl32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
