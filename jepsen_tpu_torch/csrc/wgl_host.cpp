// wgl_host: the narrow (W <= 32) and wide (W = 32 L <= 1024) WGL chunk
// on one host core, for CPU tensors.
//
// Replaces the host build of jepsen_tpu/ops/wgl32.py::_build_search32 ->
// chunk_fn (:725), chunk_fn_batched (:757), jepsen_tpu/ops/wgln.py::
// _build_searchN -> chunk_fn (:322) and the CPU lanes of
// jepsen_tpu/parallel/batched.py::_compiled_batched (:234): the same
// jitted programs the reference compiles for a host core when it is
// asked for `platform="cpu"` (its competition's `device@cpu` lane).
// Written from the plain specs, jepsen_tpu_torch/ops/wgl32.py
// (`candidates`, `_fnv`, `_round_ref`, `finish_round`, `run_chunk`) and
// jepsen_tpu_torch/ops/wgln.py (`_round_ref`), with their host-layout
// semantics (depth 1, compact off), and equal to them bit for bit on
// every carry leaf and on the packed summary:
//   * a configuration is one packed int32 row
//       [base, L window lanes, mst, Il info words]   (C = 2 + L + Il);
//     the narrow layout is L = 1 with W <= 32;
//   * a round expands the K frontier rows into R = K (W + ic) successor
//     rows, first the K W ok-rows row-major, then the K ic info-rows;
//     dead parent rows keep their slots and are hashed and probed like
//     live ones (the memo-hit count counts them);
//   * every row is hashed into three FNV words and probed against the
//     memo table as it stood before the round (4 probes by default,
//     the first empty slot is the insert slot); the inserting rows then
//     write their entries in row order, so the highest row wins a slot
//     several rows claim, and a row whose slot went to a twin of its own
//     signature counts as seen;
//   * the survivors go in row order to the next frontier, the rest
//     spill to the backlog after its rows, and the frontier refills
//     LIFO from the backlog's top;
//   * flags, stats and one occupancy-ring row a round; the summary is
//     [fr_cnt, flags x3, stats x6, bk_cnt, ring].
// uint32 words wrap as uint32; a table index out of range is an error
// (the plain version raises there).
//
// One core, one pass per phase over plain arrays: no threads, no SIMD
// intrinsics. The entry points are plain C; the Python side binds them
// with ctypes.CDLL, which releases the GIL for the length of a call, so
// another Python thread (the competition's oracle) runs meanwhile.
//
// `cancel`, where not null, is a word another thread may set (a
// competition race's verdict, ops/wgl32.py::CancelFlag): the chunk reads
// it after every round and ends there once it is set, every leaf then
// as a chunk of the rounds run leaves it. A losing host lane so stops
// within one round of the race's verdict, and the calling thread never
// wakes to poll it.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int kRingRows = 512;
constexpr int kRingCols = 7;
constexpr int kSummaryHead = 11;
constexpr int32_t kInf = 0x7fffffff;
constexpr uint32_t kPrime = 16777619u;
constexpr uint32_t kSeeds[3] = {0x811C9DC5u, 0x01000193u, 0xDEADBEEFu};

enum Err : int {
  kOk = 0,
  kBadArgs = 1,
  kNoMemory = 2,
  kTkIndex = 3,
  kMetaIndex = 4,
  kInternal = 5,
};

struct Params {
  const int32_t* meta;  // (n_pad + 1, 4): inv, ret, opcode, sufminret
  const int32_t* tk;    // (O * S,): tk[o * S + s] = T[s, o]
  const int32_t* iinv;  // (ic,)
  const int32_t* iopc;  // (ic,)
  int32_t* fr;          // (K, C)
  int32_t* fr_cnt;      // ()
  int32_t* bk;          // (B, C)
  int32_t* bk_cnt;      // ()
  int32_t* table;       // (H, 4)
  int32_t* flags;       // (3,): found, overflow, exhausted
  int32_t* stats;       // (6,)
  int32_t* ring;        // (kRingRows, kRingCols)
  int32_t* summary;     // (kSummaryHead + kRingRows * kRingCols,)
  const int32_t* cancel;  // () or null
  int K, W, L, ic, Il, C, H, B, rounds, probes, n_pad, S, n_tk, n_ok,
      n_info, max_cfg;
};

inline uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * kPrime;
  return h ^ (h >> 15);
}

// trailing zeros of a uint32; 32 for 0
inline int ctz32(uint32_t x) { return x ? __builtin_ctz(x) : 32; }

inline bool linearized(const int32_t* row, int j) {
  return ((uint32_t)row[1 + (j >> 5)] >> (j & 31)) & 1u;
}

// The scratch of one chunk, reused by every round: the round's explore
// rows (legal, not a success: the only rows that may insert or survive)
// in row order, and one row's words. A row that does not explore needs
// nothing past its probe.
struct Scratch {
  std::vector<uint32_t> row;   // (E,): its successor row's index
  std::vector<uint32_t> sig;   // (E, 3)
  std::vector<uint32_t> ins;   // (E,): its insert slot
  std::vector<uint8_t> flag;   // (E,)
  std::vector<int32_t> succ;   // (E, C)
  std::vector<int32_t> nfr;    // (K, C): the next frontier
  std::vector<uint32_t> word;  // (C,): one row's words
};

enum : uint8_t {
  kSeen = 1,    // signature found by the probe
  kInsert = 2,  // unseen, and an empty probe slot exists
};

// The chunk's scalar state between rounds.
struct State {
  int fr_cnt, bk_cnt;
  int flags[3];
  uint32_t stats[6];
};

// Parent k's min ret over its open window slots and its tail: a
// candidate must be invoked before it.
int parent_minret(const Params& p, const int32_t* row, int32_t* out) {
  const long long base = row[0];
  long long tailp = base + p.W;
  if (tailp > p.n_pad) tailp = p.n_pad;
  if (tailp < 0) return kMetaIndex;
  int32_t mr = p.meta[tailp * 4 + 3];
  for (int j = 0; j < p.W; ++j) {
    const long long pos = base + j;
    if (linearized(row, j) || pos >= p.n_ok) continue;
    const long long posc = pos < p.n_pad - 1 ? pos : p.n_pad - 1;
    if (posc < 0) return kMetaIndex;
    const int32_t r = p.meta[posc * 4 + 1];
    if (r < mr) mr = r;
  }
  *out = mr;
  return kOk;
}

// One successor row's words into w and its legality into *legal (the
// candidate rules of ops/wgl32.py::candidates); returns 0 or an error
// code.
struct Expand {
  const Params& p;
  const int32_t* cur;
  const int32_t* minret;
  int fr_cnt;

  // ok-row: parent k linearizes window slot j
  int ok_row(int k, int j, uint32_t* w, bool* legal) const {
    const int L = p.L, mstc = 1 + L;
    const int32_t* row = cur + (size_t)k * p.C;
    const long long base = row[0];
    const long long pos = base + j;
    const long long posc = pos < p.n_pad - 1 ? pos : p.n_pad - 1;
    if (posc < 0) return kMetaIndex;
    const long long ti = (long long)p.meta[posc * 4 + 2] * p.S + row[mstc];
    if (ti < 0 || ti >= p.n_tk) return kTkIndex;
    const int32_t nst = p.tk[ti];
    const bool alive = k < fr_cnt;
    *legal = alive && !linearized(row, j) && pos < p.n_ok &&
             p.meta[posc * 4 + 0] < minret[k] && nst >= 0;
    // set bit j, then shift the window right past its t = 32 q + rr
    // leading linearized slots: q the first lane with a zero bit (L when
    // every lane is full), rr that lane's trailing ones
    const int jl = j >> 5;
    const uint32_t jb = 1u << (j & 31);
    auto lane = [&](int i) -> uint32_t {
      if (i >= L) return 0u;
      const uint32_t v = (uint32_t)row[1 + i];
      return i == jl ? v | jb : v;
    };
    int q = L, rr = 0;
    for (int l = 0; l < L; ++l) {
      const uint32_t v = lane(l);
      if (v != 0xFFFFFFFFu) {
        q = l;
        rr = ctz32(~v);
        break;
      }
    }
    w[0] = (uint32_t)(base + 32LL * q + rr);
    for (int l = 0; l < L; ++l) {
      const uint32_t g0 = lane(l + q);
      // rr == 0 takes g0 alone: a 32-bit shift is no funnel shift
      w[1 + l] = rr == 0 ? g0 : (g0 >> rr) | (lane(l + q + 1) << (32 - rr));
    }
    w[mstc] = (uint32_t)nst;
    for (int i = 0; i < p.Il; ++i)
      w[mstc + 1 + i] = (uint32_t)row[mstc + 1 + i];
    return kOk;
  }

  // info-row: parent k takes crashed op m
  int info_row(int k, int m, uint32_t* w, bool* legal) const {
    const int L = p.L, mstc = 1 + L;
    const int32_t* row = cur + (size_t)k * p.C;
    const long long ti = (long long)p.iopc[m] * p.S + row[mstc];
    if (ti < 0 || ti >= p.n_tk) return kTkIndex;
    const int32_t nst = p.tk[ti];
    const uint32_t iw = (uint32_t)row[mstc + 1 + (m >> 5)];
    const bool set = (iw >> (m & 31)) & 1u;
    const bool alive = k < fr_cnt;
    *legal = alive && !set && m < p.n_info && p.iinv[m] < minret[k] &&
             nst >= 0;
    for (int i = 0; i < mstc; ++i) w[i] = (uint32_t)row[i];
    w[mstc] = (uint32_t)nst;
    for (int i = 0; i < p.Il; ++i) {
      uint32_t v = (uint32_t)row[mstc + 1 + i];
      if (i == (m >> 5)) v |= 1u << (m & 31);
      w[mstc + 1 + i] = v;
    }
    return kOk;
  }
};

// The round's probe of one successor row (words w, index r, legality):
// its signature, a success or a legal base, and, where it explores, an
// entry in the scratch's explore list; a row that does not explore and
// whose signature is in the table counts a memo hit at once.
struct Probe {
  const Params& p;
  Scratch& s;
  const uint32_t* table;
  bool found = false;
  long long base_max = 0;
  long long seen_n = 0;

  void row(const uint32_t* w, uint32_t r, bool legal) {
    const int C = p.C, L = p.L;
    const long long base_s = (int32_t)w[0];
    bool empty_win = true;
    for (int l = 0; l < L; ++l) empty_win &= w[1 + l] == 0u;
    const bool success = legal && base_s >= p.n_ok && empty_win;
    found |= success;
    if (legal && base_s > base_max) base_max = base_s;
    uint32_t h0 = kSeeds[0], h1 = kSeeds[1], h2 = kSeeds[2];
    for (int i = 0; i < C; ++i) {
      h0 = fnv_step(h0, w[i]);
      h1 = fnv_step(h1, w[i]);
      h2 = fnv_step(h2, w[i]);
    }
    const uint32_t a = h0 | 1u;  // never 0: 0 marks an empty slot
    const uint32_t step = h1 | 1u;
    const uint32_t hmask = (uint32_t)(p.H - 1);
    bool seen = false;
    int first = -1;
    for (int q = 0; q < p.probes; ++q) {
      const uint32_t* slot =
          table + (size_t)((a + (uint32_t)q * step) & hmask) * 4;
      const bool occ = slot[0] != 0u;
      seen |= occ && slot[0] == a && slot[1] == h1 && slot[2] == h2;
      if (!occ && first < 0) first = q;
    }
    if (!legal || success) {
      seen_n += seen;
      return;
    }
    s.row.push_back(r);
    s.sig.push_back(a);
    s.sig.push_back(h1);
    s.sig.push_back(h2);
    s.ins.push_back((a + (uint32_t)(first < 0 ? 0 : first) * step) & hmask);
    s.flag.push_back((seen ? kSeen : 0) | (!seen && first >= 0 ? kInsert : 0));
    s.succ.insert(s.succ.end(), reinterpret_cast<const int32_t*>(w),
                  reinterpret_cast<const int32_t*>(w) + C);
  }
};

// One round on the frontier `cur` (K, C): the next frontier goes into
// s.nfr, the scalar state `st` is updated.
int round(const Params& p, const int32_t* cur, Scratch& s, State& st,
          std::vector<int32_t>& minret) {
  const int K = p.K, W = p.W, ic = p.ic, C = p.C;
  const int fr_cnt = st.fr_cnt;
  uint32_t* tab = reinterpret_cast<uint32_t*>(p.table);
  uint32_t* w = s.word.data();
  s.row.clear();
  s.sig.clear();
  s.ins.clear();
  s.flag.clear();
  s.succ.clear();

  for (int k = 0; k < K; ++k) {
    minret[k] = kInf;
    if (k < fr_cnt) {
      const int rc = parent_minret(p, cur + (size_t)k * C, &minret[k]);
      if (rc != kOk) return rc;
    }
  }

  // ---- expand, hash and probe every successor row in row order (the
  // K W ok-rows, then the K ic info-rows) against the table as it stood
  // before the round
  const Expand ex{p, cur, minret.data(), fr_cnt};
  Probe pb{p, s, tab};
  uint32_t r = 0;
  for (int k = 0; k < K; ++k) {
    for (int j = 0; j < W; ++j, ++r) {
      bool legal;
      const int rc = ex.ok_row(k, j, w, &legal);
      if (rc != kOk) return rc;
      pb.row(w, r, legal);
    }
  }
  for (int k = 0; k < K; ++k) {
    for (int m = 0; m < ic; ++m, ++r) {
      bool legal;
      const int rc = ex.info_row(k, m, w, &legal);
      if (rc != kOk) return rc;
      pb.row(w, r, legal);
    }
  }

  // ---- insert in row order: the highest row wins a slot
  const size_t E = s.row.size();
  for (size_t e = 0; e < E; ++e) {
    if (!(s.flag[e] & kInsert)) continue;
    uint32_t* slot = tab + (size_t)s.ins[e] * 4;
    slot[0] = s.sig[3 * e];
    slot[1] = s.sig[3 * e + 1];
    slot[2] = s.sig[3 * e + 2];
    slot[3] = s.row[e];
  }

  // ---- a row whose slot a twin won is seen; the rest survive, in row
  // order, into the next frontier and past it the backlog
  const int bk_cnt = st.bk_cnt;
  long long seen_n = pb.seen_n, total = 0;
  bool overflow = false;
  int32_t* nfr = s.nfr.data();
  for (size_t e = 0; e < E; ++e) {
    bool seen = s.flag[e] & kSeen;
    if (s.flag[e] & kInsert) {
      const uint32_t* slot = tab + (size_t)s.ins[e] * 4;
      seen = slot[0] == s.sig[3 * e] && slot[1] == s.sig[3 * e + 1] &&
             slot[2] == s.sig[3 * e + 2] && slot[3] != s.row[e];
    }
    if (seen) {
      ++seen_n;
      continue;
    }
    const long long posn = total++;
    const int32_t* src = &s.succ[e * C];
    if (posn < K) {
      std::memcpy(nfr + (size_t)posn * C, src, sizeof(int32_t) * C);
    } else if (bk_cnt + posn - K >= p.B) {
      overflow = true;
    } else {
      std::memcpy(p.bk + (size_t)(bk_cnt + posn - K) * C, src,
                  sizeof(int32_t) * C);
    }
  }
  int nfr_cnt = total < K ? (int)total : K;
  const long long nbk = bk_cnt + (total > K ? total - K : 0);
  int nbk_cnt = nbk < p.B ? (int)nbk : p.B;
  // refill LIFO from the backlog top; zero the rows past it
  const int take = K - nfr_cnt < nbk_cnt ? K - nfr_cnt : nbk_cnt;
  for (int i = 0; i < take; ++i)
    std::memcpy(nfr + (size_t)(nfr_cnt + i) * C,
                p.bk + (size_t)(nbk_cnt - 1 - i) * C, sizeof(int32_t) * C);
  nfr_cnt += take;
  nbk_cnt -= take;
  std::memset(nfr + (size_t)nfr_cnt * C, 0,
              sizeof(int32_t) * (size_t)(K - nfr_cnt) * C);

  // ---- flags, stats, one ring row
  uint32_t* sv = st.stats;
  const uint32_t bmax =
      (int32_t)sv[2] > pb.base_max ? sv[2] : (uint32_t)pb.base_max;
  const uint32_t ridx = sv[1];
  sv[0] += (uint32_t)fr_cnt;
  sv[1] += 1u;
  sv[2] = bmax;
  sv[3] += (uint32_t)seen_n;
  sv[4] += (uint32_t)total;
  sv[5] += 1u;
  st.flags[0] |= pb.found;
  st.flags[1] |= overflow;
  st.flags[2] = nfr_cnt == 0;
  if (ridx < (uint32_t)kRingRows) {
    int32_t* rw = p.ring + (size_t)ridx * kRingCols;
    rw[0] = (int32_t)sv[5];
    rw[1] = fr_cnt;
    rw[2] = (int32_t)(uint32_t)seen_n;
    rw[3] = (int32_t)(uint32_t)total;
    rw[4] = nfr_cnt;
    rw[5] = nbk_cnt;
    rw[6] = (int32_t)bmax;
  }
  st.fr_cnt = nfr_cnt;
  st.bk_cnt = nbk_cnt;
  return kOk;
}

int run_chunk(const Params& p) {
  State st;
  st.fr_cnt = *p.fr_cnt;
  st.bk_cnt = *p.bk_cnt;
  for (int i = 0; i < 3; ++i) st.flags[i] = p.flags[i];
  for (int i = 0; i < 6; ++i) st.stats[i] = (uint32_t)p.stats[i];
  st.stats[1] = 0;
  try {
    Scratch s;
    std::vector<int32_t> minret;
    bool ran = false;
    while (!st.flags[0] && st.fr_cnt > 0 &&
           (int32_t)st.stats[1] < p.rounds &&
           (int32_t)st.stats[0] < p.max_cfg) {
      if (ran && p.cancel && __atomic_load_n(p.cancel, __ATOMIC_RELAXED))
        break;
      if (!ran) {
        s.nfr.resize((size_t)p.K * p.C);
        s.word.resize((size_t)p.C);
        minret.resize((size_t)p.K);
        ran = true;
      }
      const int rc = round(p, p.fr, s, st, minret);
      if (rc != kOk) return rc;
      std::memcpy(p.fr, s.nfr.data(), sizeof(int32_t) * (size_t)p.K * p.C);
    }
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kInternal;
  }
  *p.fr_cnt = st.fr_cnt;
  *p.bk_cnt = st.bk_cnt;
  for (int i = 0; i < 3; ++i) p.flags[i] = st.flags[i];
  for (int i = 0; i < 6; ++i) p.stats[i] = (int32_t)st.stats[i];
  int32_t* sm = p.summary;
  sm[0] = st.fr_cnt;
  for (int i = 0; i < 3; ++i) sm[1 + i] = st.flags[i];
  for (int i = 0; i < 6; ++i) sm[4 + i] = (int32_t)st.stats[i];
  sm[10] = st.bk_cnt;
  std::memcpy(sm + kSummaryHead, p.ring,
              sizeof(int32_t) * kRingRows * kRingCols);
  return kOk;
}

int check(const Params& p) {
  if (p.K < 1 || p.B < 1 || p.ic < 0 || p.W < 1 || p.L < 1 ||
      p.W > 32 * p.L || p.probes < 1 || p.H < 1 || (p.H & (p.H - 1)) ||
      p.n_pad < 1 || p.S < 1 || p.n_tk < 0 || p.rounds < 0)
    return kBadArgs;
  if ((long long)p.K * (p.W + p.ic) >= 0x7fffffffLL) return kBadArgs;
  return kOk;
}

Params make(const int32_t* meta, const int32_t* tk, const int32_t* iinv,
            const int32_t* iopc, int32_t* fr, int32_t* fr_cnt, int32_t* bk,
            int32_t* bk_cnt, int32_t* table, int32_t* flags, int32_t* stats,
            int32_t* ring, int32_t* summary, int K, int W, int L, int ic,
            int H, int B, int rounds, int probes, int n_pad, int S, int O,
            int n_ok, int n_info, int max_cfg, const int32_t* cancel) {
  Params p;
  p.meta = meta;
  p.tk = tk;
  p.iinv = iinv;
  p.iopc = iopc;
  p.fr = fr;
  p.fr_cnt = fr_cnt;
  p.bk = bk;
  p.bk_cnt = bk_cnt;
  p.table = table;
  p.flags = flags;
  p.stats = stats;
  p.ring = ring;
  p.summary = summary;
  p.K = K;
  p.W = W;
  p.L = L;
  p.ic = ic;
  p.Il = ic > 0 ? (ic + 31) / 32 : 1;
  p.C = 2 + L + p.Il;
  p.H = H;
  p.B = B;
  p.rounds = rounds;
  p.probes = probes;
  p.n_pad = n_pad;
  p.S = S;
  p.n_tk = O * S;
  p.n_ok = n_ok;
  p.n_info = n_info;
  p.max_cfg = max_cfg;
  p.cancel = cancel;
  return p;
}

int solo(const Params& p) {
  const int rc = check(p);
  return rc != kOk ? rc : run_chunk(p);
}

// lane i of a batch: every array offset by the lane's slice
int batched(const int32_t* meta, const int32_t* tk, const int32_t* iinv,
            const int32_t* iopc, int32_t* fr, int32_t* fr_cnt, int32_t* bk,
            int32_t* bk_cnt, int32_t* table, int32_t* flags, int32_t* stats,
            int32_t* ring, int32_t* summary, const int32_t* n_ok,
            const int32_t* n_info, const int32_t* max_cfg, int K, int W,
            int L, int ic, int H, int B, int rounds, int probes, int n_pad,
            int S, int O, int lanes) {
  if (lanes < 1) return kBadArgs;
  for (int i = 0; i < lanes; ++i) {
    Params p = make(meta, tk, iinv, iopc, fr, fr_cnt, bk, bk_cnt, table,
                    flags, stats, ring, summary, K, W, L, ic, H, B, rounds,
                    probes, n_pad, S, O, n_ok[i], n_info[i], max_cfg[i],
                    nullptr);
    const size_t C = (size_t)p.C;
    p.meta += (size_t)i * (n_pad + 1) * 4;
    p.tk += (size_t)i * O * S;
    p.iinv += (size_t)i * ic;
    p.iopc += (size_t)i * ic;
    p.fr += (size_t)i * K * C;
    p.fr_cnt += i;
    p.bk += (size_t)i * B * C;
    p.bk_cnt += i;
    p.table += (size_t)i * H * 4;
    p.flags += (size_t)i * 3;
    p.stats += (size_t)i * 6;
    p.ring += (size_t)i * kRingRows * kRingCols;
    p.summary += (size_t)i * (kSummaryHead + kRingRows * kRingCols);
    const int rc = solo(p);
    if (rc != kOk) return rc;
  }
  return kOk;
}

}  // namespace

#define WGL_HOST_ARGS                                                      \
  const int32_t *meta, const int32_t *tk, const int32_t *iinv,             \
      const int32_t *iopc, int32_t *fr, int32_t *fr_cnt, int32_t *bk,      \
      int32_t *bk_cnt, int32_t *table, int32_t *flags, int32_t *stats,     \
      int32_t *ring, int32_t *summary
#define WGL_HOST_PTRS                                                      \
  meta, tk, iinv, iopc, fr, fr_cnt, bk, bk_cnt, table, flags, stats, ring, \
      summary

// The solo chunk: 13 pointers and the cancel word (or null), then K, W,
// L, ic, H, B, rounds, probes, n_pad, S, O, n_ok, n_info, max_cfg.
// Returns 0 or an error code.
extern "C" int wgl32_host_chunk(WGL_HOST_ARGS, const int32_t* cancel, int K,
                                int W, int L, int ic, int H, int B,
                                int rounds, int probes, int n_pad, int S,
                                int O, int n_ok, int n_info, int max_cfg) {
  if (L != 1 || W > 32) return kBadArgs;
  return solo(make(WGL_HOST_PTRS, K, W, L, ic, H, B, rounds, probes, n_pad,
                   S, O, n_ok, n_info, max_cfg, cancel));
}

extern "C" int wgln_host_chunk(WGL_HOST_ARGS, const int32_t* cancel, int K,
                               int W, int L, int ic, int H, int B,
                               int rounds, int probes, int n_pad, int S,
                               int O, int n_ok, int n_info, int max_cfg) {
  if (L < 2 || L > 32 || W != 32 * L) return kBadArgs;
  return solo(make(WGL_HOST_PTRS, K, W, L, ic, H, B, rounds, probes, n_pad,
                   S, O, n_ok, n_info, max_cfg, cancel));
}

// The lane-batched chunk: the 13 pointers and the lanes' n_ok, n_info
// and max_cfg, then K, W, L, ic, H, B, rounds, probes, n_pad, S, O,
// lanes; each lane runs the solo chunk on its slice in turn.
extern "C" int wgl32_host_chunk_batched(WGL_HOST_ARGS, const int32_t* n_ok,
                                        const int32_t* n_info,
                                        const int32_t* max_cfg, int K,
                                        int W, int L, int ic, int H, int B,
                                        int rounds, int probes, int n_pad,
                                        int S, int O, int lanes) {
  if (L != 1 || W > 32) return kBadArgs;
  return batched(WGL_HOST_PTRS, n_ok, n_info, max_cfg, K, W, L, ic, H, B,
                 rounds, probes, n_pad, S, O, lanes);
}

extern "C" int wgln_host_chunk_batched(WGL_HOST_ARGS, const int32_t* n_ok,
                                       const int32_t* n_info,
                                       const int32_t* max_cfg, int K, int W,
                                       int L, int ic, int H, int B,
                                       int rounds, int probes, int n_pad,
                                       int S, int O, int lanes) {
  if (L < 2 || L > 32 || W != 32 * L) return kBadArgs;
  return batched(WGL_HOST_PTRS, n_ok, n_info, max_cfg, K, W, L, ic, H, B,
                 rounds, probes, n_pad, S, O, lanes);
}

extern "C" const char* wgl_host_error_string(int code) {
  switch (code) {
    case kOk: return "ok";
    case kBadArgs: return "bad arguments";
    case kNoMemory: return "out of host memory for the round's scratch";
    case kTkIndex: return "transition table index out of range";
    case kMetaIndex: return "op metadata index out of range";
    default: return "internal error";
  }
}
