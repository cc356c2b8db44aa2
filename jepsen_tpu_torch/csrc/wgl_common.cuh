// wgl_common.cuh: the chunk loop of the WGL linearizability search, for
// Hopper (sm_90a), shared by the narrow (wgl32_chunk.cu, W <= 32) and
// the wide (wgln_chunk.cu, W = 32 L <= 1024) kernels.
//
// A configuration is one packed int32 row
//     [base, L window lanes, mst, Il info words]       (C = 2 + L + Il)
// (the narrow kernel is L = 1). One chunk runs up to `chunk` rounds in
// ONE persistent CTA of kThreads threads, with __syncthreads() between
// phases, and writes the packed poll summary. What bounds a round and
// why the design is one CTA is written at the top of wgl32_chunk.cu.
//
// The phases of one round (R = K*(W + ic) successor rows in JAX's
// layout: first the K*W ok-rows row-major, then the K*ic info-rows;
// dead parent rows keep their slots and are processed like live ones,
// because the memo-hit counter of the reference counts them):
//   1. expand: per-parent min unlinearized ret, then one thread per
//      successor row: legality, successor words, FNV signatures. Only
//      the ok-row's window update differs between the layouts: it is
//      the `Layout` parameter of chunk_body (ok_shift, ok_lane).
//   2. probe: read the probe slots; `seen`, the first empty slot; rows
//      that insert claim the slot with atomicMax(w3, row + 1).
//   3. insert: the row that won (the highest, as XLA's scatter keeps
//      the last duplicate) writes [s0, s1, s2, row].
//   4. verify: a twin that lost the slot to the same signature is seen.
//   5. compact: block-wide exclusive scan of `new`; the first K go to
//      the next frontier, the rest spill to the backlog.
//   6. refill LIFO from the backlog top.
//   7. bookkeeping: flags, stats, one occupancy-ring row.
//
// The plain PyTorch versions (ops/wgl32.py::chunk_ref and
// ops/wgln.py::chunk_ref) agree with these kernels bit for bit on
// every carry leaf and on the summary.
//
// The lane-batched kernels (wgl32_chunk_batched, wgln_chunk_batched)
// run the same chunk_body once per lane: a grid of `lanes` CTAs, CTA l
// on lane l's slice of every array (make_lane_params), each to its own
// stop. chunk_body is block-local (its state is __shared__, nothing
// crosses blocks), so a lane that stops early is frozen exactly as the
// JAX package's vmapped while_loop freezes it by select.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wgl {

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
  int K, W, L, ic, Il, mst, C, H, B, chunk, probes, n_pad, S, n_ok,
      n_info, max_cfg;
};

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

template <class Layout>
__device__ __forceinline__ void chunk_body(const Params& p) {
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
  const int L = Layout::lanes(p);
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
      int32_t mr = kInf;
      for (int j = 0; j < W; ++j) {
        const int pos = base + j;
        const int posc = min(pos, p.n_pad - 1);
        if (!linearized(row, j) && pos < p.n_ok)
          mr = min(mr, p.meta[posc * 4 + 1]);
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
      const int mst = row[p.mst];
      const bool alive = k < fr_cnt;
      const int32_t mr = minret[k];
      int nst;
      bool legal;
      RowWriter w(succ + (size_t)r * C);
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
      for (int i = 0; i < Il; ++i) {
        uint32_t v = (uint32_t)row[p.mst + 1 + i];
        if (!okrow && i == (m >> 5)) v |= 1u << (m & 31);
        w.push(v);
      }
      const bool success = legal && base_s >= p.n_ok && any_lane == 0u;
      found |= success;
      if (legal) bmax = max(bmax, base_s);
      s0[r] = w.h0 | 1u;  // never 0: 0 marks an empty slot
      s1[r] = w.h1;
      s2[r] = w.h2;
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

// The kernels' shared C interface (ops/_native.py binds it): 14 device
// pointers, 13 int32 scalars and the stream.
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
// and max_cfg are per-lane device int32 arrays. 17 device pointers, 12
// int32 scalars and the stream.
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
  int32_t* scratch;        // (lanes, scratch words)
  const int32_t* n_ok;     // (lanes,)
  const int32_t* n_info;   // (lanes,)
  const int32_t* max_cfg;  // (lanes,)
  int K, W, L, ic, H, B, chunk, probes, n_pad, S, O, lanes;
};

// Lane l's Params: the per-lane strides of every array and lane l's
// scalars (read from device memory, so call it on the device). The
// scratch size per lane is ops/wgl32.py::scratch_words.
__device__ inline Params make_lane_params(const BatchParams& b, int l) {
  const size_t lz = static_cast<size_t>(l);
  const int Il = b.ic > 32 ? (b.ic + 31) / 32 : 1;
  const size_t C = static_cast<size_t>(2 + b.L + Il);
  const size_t R = static_cast<size_t>(b.K) * (b.W + b.ic);
  const size_t scratch = R * (C + 5) + b.K + static_cast<size_t>(b.K) * C;
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
template <class Layout>
__device__ __forceinline__ void lane_chunk_body(const BatchParams& b) {
  __shared__ Params sp;
  if (threadIdx.x == 0) sp = make_lane_params(b, blockIdx.x);
  __syncthreads();
  chunk_body<Layout>(sp);
}

}  // namespace wgl

#define WGL_CHUNK_ARGS                                                      \
  const int32_t *meta, const int32_t *tk, const int32_t *iinv,              \
      const int32_t *iopc, int32_t *fr, int32_t *fr_cnt, int32_t *bk,       \
      int32_t *bk_cnt, int32_t *table, int32_t *flags, int32_t *stats,      \
      int32_t *ring, int32_t *summary, int32_t *scratch, int K, int W, int L, \
      int ic, int H, int B, int chunk, int probes, int n_pad, int S,        \
      int n_ok, int n_info, int max_cfg, void *stream

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
      int n_pad, int S, int O, int lanes, void *stream

#define WGL_BATCHED_PARAMS                                                  \
  wgl::BatchParams {                                                        \
    meta, tk, iinv, iopc, fr, fr_cnt, bk, bk_cnt, table, flags, stats,      \
        ring, summary, scratch, n_ok, n_info, max_cfg, K, W, L, ic, H, B,   \
        chunk, probes, n_pad, S, O, lanes                                   \
  }
