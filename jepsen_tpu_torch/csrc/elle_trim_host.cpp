// elle_trim_host: Elle's peel-to-core cycle existence test on one host
// core, for CPU tensors.
//
// Replaces the host build of jepsen_tpu/elle/tpu.py::make_trim_kernel
// (:899), compiled for the CPU by _compiled_trim (:1027): the program the
// reference runs for every Elle device check on a CPU backend. Written
// from the plain spec, jepsen_tpu_torch/elle/tpu.py::trim_ref, and equal
// to it bit for bit on the live planes, every counts row and the body
// count; the design is the counter design of csrc/elle_trim.cu (its
// header), on one core:
//   * per subset s, each node's count of masked in-slots and out-slots
//     whose neighbor is live, and the transposes of both padded lists
//     (for a source j, the nodes whose list names j: a CSR built once);
//   * a peel reads has_in / has_out from the counts and, with the
//     process chains on, from the min / max chain position over the live
//     nodes of each process segment (recomputed every peel, over the
//     live nodes only);
//   * with the realtime thresholds on, the in-pool's min completion and
//     the out-pool's max invocation, each with its first argmin /
//     argmax row and the extremum over every other row, come from two
//     monotone pointers over the rows sorted by (completion, row) and by
//     (-invocation, row): the pools only shrink (live shrinks, and the
//     edge and process support with it), so the first two members of a
//     pool in its order only move forward;
//   * every death of a peel is decided on the peel's live set first,
//     then applied: only the nodes that die walk their transposed lists,
//     decrementing the counts they name.
// A loop body runs two peels and writes the subset's live count into row
// min(body, rows - 1); a subset stops at the first body whose count
// repeats its last (the first body's last is -1), at most n_pad bodies.
// The subsets are independent: the reference's joint stop (run while ANY
// subset changed) is the largest of their body counts, a stopped subset
// repeating its final count in the later rows, and the rows past the
// joint count zero.
//
// Pools' extrema as the reference's argmin / argmax over every row give
// them: ties go to the lowest row, and a pool whose first member holds
// the sentinel (every row then holds it: no member, or the members'
// events absent) answers (2^30, row 0, 2^30), so row 0 takes the second
// extremum. Every compare is in int32, against the +-2^30 sentinels that
// elle/tpu.py::trim_inputs writes.
//
// Scratch comes from the host (std::vector), per call: no threads and
// no state shared between calls. The entry point is plain C; the Python
// side binds it with ctypes.CDLL, which releases the GIL for the length
// of a call, so calls from several Python threads run at once.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <new>
#include <vector>

namespace {

constexpr int32_t kBig = 1 << 30;

enum Err : int {
  kOk = 0,
  kBadArgs = 1,
  kNoMemory = 2,
  kNeighborIndex = 3,
  kProcessIndex = 4,
};

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
  int n_pad, d_in, d_out, S, p_pad, use_rt, use_proc, rows;
};

// (value, first row, extremum over every other row)
struct Ext {
  int32_t v1, i1, v2;
};

// One transposed list set: for source j, ent[start[j], start[j + 1]).
struct Csr {
  std::vector<int32_t> start;
  std::vector<int32_t> ent;
};

// The pool's extremum by a monotone pointer pair over `order` (the rows
// sorted by the pool's key, then by row): the first two members; `big`
// is the value of a row outside the pool.
struct Pointers {
  const std::vector<int32_t>* order;
  int first = 0, second = 1;

  template <class InPool>
  Ext ext(InPool in_pool, const int32_t* vals, int32_t big) {
    const std::vector<int32_t>& o = *order;
    const int n = static_cast<int>(o.size());
    while (first < n && !in_pool(o[first])) ++first;
    second = std::max(second, first + 1);
    while (second < n && !in_pool(o[second])) ++second;
    if (first == n || vals[o[first]] == big) return {big, 0, big};
    return {vals[o[first]], o[first], second < n ? vals[o[second]] : big};
  }
};

// The transpose of one padded list for subset s: the nodes i whose slot
// d is masked, filed under neigh[i, d], and each node's count of masked
// slots whose neighbor is live. Returns false on an index out of range.
bool transpose(const int32_t* neigh, const uint8_t* mask, int d,
               const Params& p, int s, const std::vector<uint8_t>& live,
               Csr& t, std::vector<int32_t>& cnt) {
  const int N = p.n_pad, S = p.S;
  t.start.assign(N + 1, 0);
  cnt.assign(N, 0);
  for (int i = 0; i < N; ++i)
    for (int k = 0; k < d; ++k) {
      if (!mask[(static_cast<size_t>(i) * d + k) * S + s]) continue;
      const int32_t j = neigh[static_cast<size_t>(i) * d + k];
      if (j < 0 || j >= N) return false;
      ++t.start[j + 1];
      cnt[i] += live[j];
    }
  for (int j = 0; j < N; ++j) t.start[j + 1] += t.start[j];
  t.ent.resize(t.start[N]);
  std::vector<int32_t> at(t.start.begin(), t.start.end() - 1);
  for (int i = 0; i < N; ++i)
    for (int k = 0; k < d; ++k)
      if (mask[(static_cast<size_t>(i) * d + k) * S + s])
        t.ent[at[neigh[static_cast<size_t>(i) * d + k]]++] = i;
  return true;
}

// The scratch of one subset's fixpoint, reused by the next subset.
struct Scratch {
  std::vector<uint8_t> live;     // (N,)
  std::vector<uint8_t> sup;      // (N,): bit 0 has_in, bit 1 has_out
  std::vector<int32_t> cin, cout;
  Csr tin, tout;
  std::vector<int32_t> alive;    // the live nodes, ascending
  std::vector<int32_t> died;     // this peel's deaths
  std::vector<int32_t> segmin, segmax;  // (p_pad,)
};

// One peel of subset s: decide every death on the live set, then apply
// them (the counts of the nodes that list a dead node drop).
void peel(const Params& p, Scratch& w, const std::vector<uint8_t>& inverted,
          Pointers& ptr_in, Pointers& ptr_out) {
  if (p.use_proc) {
    for (int32_t i : w.alive) {
      w.segmin[p.proc[i]] = INT_MAX;
      w.segmax[p.proc[i]] = INT_MIN;
    }
    for (int32_t i : w.alive) {
      int32_t& lo = w.segmin[p.proc[i]];
      int32_t& hi = w.segmax[p.proc[i]];
      lo = std::min(lo, p.ppos[i]);
      hi = std::max(hi, p.ppos[i]);
    }
  }
  for (int32_t i : w.alive) {
    bool hi = w.cin[i] > 0, ho = w.cout[i] > 0;
    if (p.use_proc) {
      const int32_t pp = p.ppos[i], pr = p.proc[i];
      hi = hi || pp > w.segmin[pr];
      ho = ho || (pp < w.segmax[pr] && pp >= 0);
    }
    w.sup[i] = static_cast<uint8_t>(hi | (ho << 1));
  }
  // the anchored thresholds, from this peel's support before any death
  Ext a{0, 0, 0}, b{0, 0, 0};
  if (p.use_rt) {
    const uint8_t* live = w.live.data();
    const uint8_t* sup = w.sup.data();
    const uint8_t* inv_d = inverted.data();
    a = ptr_in.ext(
        [&](int32_t i) { return live[i] && ((sup[i] & 1) || inv_d[i]); },
        p.comp, kBig);
    b = ptr_out.ext(
        [&](int32_t i) { return live[i] && ((sup[i] & 2) || inv_d[i]); },
        p.inv, -kBig);
  }
  w.died.clear();
  for (int32_t i : w.alive) {
    bool hi = w.sup[i] & 1, ho = (w.sup[i] >> 1) & 1;
    if (hi && ho) continue;
    if (p.use_rt) {
      hi = hi || p.inv[i] > (i == a.i1 ? a.v2 : a.v1);
      ho = ho || p.comp[i] < (i == b.i1 ? b.v2 : b.v1);
      if (hi && ho) continue;
    }
    w.died.push_back(i);
  }
  if (w.died.empty()) return;
  for (int32_t j : w.died) {
    w.live[j] = 0;
    for (int32_t e = w.tin.start[j]; e < w.tin.start[j + 1]; ++e)
      --w.cin[w.tin.ent[e]];
    for (int32_t e = w.tout.start[j]; e < w.tout.start[j + 1]; ++e)
      --w.cout[w.tout.ent[e]];
  }
  size_t k = 0;
  for (int32_t i : w.alive)
    if (w.live[i]) w.alive[k++] = i;
  w.alive.resize(k);
}

// Subset s's fixpoint: its live plane, its counts rows (its final count
// repeated to the last row) and its body count; -1 on a bad index.
int subset_fixpoint(const Params& p, int s, Scratch& w,
                    const std::vector<uint8_t>& inverted,
                    const std::vector<int32_t>& order_in,
                    const std::vector<int32_t>& order_out, int* err) {
  const int N = p.n_pad, S = p.S;
  w.live.resize(N);
  for (int i = 0; i < N; ++i)
    w.live[i] = p.live0[static_cast<size_t>(i) * S + s] != 0;
  if (!transpose(p.in_neigh, p.in_mask, p.d_in, p, s, w.live, w.tin,
                 w.cin) ||
      !transpose(p.out_neigh, p.out_mask, p.d_out, p, s, w.live, w.tout,
                 w.cout)) {
    *err = kNeighborIndex;
    return -1;
  }
  w.sup.assign(N, 0);
  w.alive.clear();
  for (int i = 0; i < N; ++i)
    if (w.live[i]) w.alive.push_back(i);
  Pointers ptr_in{&order_in}, ptr_out{&order_out};
  int32_t prev = -1, c = 0;
  int body = 0;
  while (body < N) {
    peel(p, w, inverted, ptr_in, ptr_out);
    peel(p, w, inverted, ptr_in, ptr_out);
    c = static_cast<int32_t>(w.alive.size());
    p.counts[static_cast<size_t>(std::min(body, p.rows - 1)) * S + s] = c;
    ++body;
    if (c == prev) break;
    prev = c;
  }
  for (int r = body; r < p.rows; ++r)
    p.counts[static_cast<size_t>(r) * S + s] = c;
  for (int i = 0; i < N; ++i)
    p.live_out[static_cast<size_t>(i) * S + s] = w.live[i];
  return body;
}

int run(const Params& p, int32_t* bodies) {
  const int N = p.n_pad;
  if (p.use_proc)
    for (int i = 0; i < N; ++i)
      if (p.proc[i] < 0 || p.proc[i] >= p.p_pad) return kProcessIndex;
  std::vector<uint8_t> inverted(N);
  for (int i = 0; i < N; ++i) inverted[i] = p.comp[i] < p.inv[i];
  // the rows by (completion, row) and by (-invocation, row)
  std::vector<int32_t> order_in, order_out;
  if (p.use_rt) {
    order_in.resize(N);
    order_out.resize(N);
    for (int i = 0; i < N; ++i) order_in[i] = order_out[i] = i;
    std::sort(order_in.begin(), order_in.end(), [&](int32_t x, int32_t y) {
      return p.comp[x] != p.comp[y] ? p.comp[x] < p.comp[y] : x < y;
    });
    std::sort(order_out.begin(), order_out.end(), [&](int32_t x, int32_t y) {
      return p.inv[x] != p.inv[y] ? p.inv[x] > p.inv[y] : x < y;
    });
  }
  Scratch w;
  if (p.use_proc) {
    w.segmin.resize(p.p_pad);
    w.segmax.resize(p.p_pad);
  }
  int total = 0, err = kOk;
  for (int s = 0; s < p.S; ++s) {
    const int body =
        subset_fixpoint(p, s, w, inverted, order_in, order_out, &err);
    if (body < 0) return err;
    total = std::max(total, body);
  }
  // the joint stop: the rows past the largest body count are zero
  for (int r = total; r < p.rows; ++r)
    for (int s = 0; s < p.S; ++s)
      p.counts[static_cast<size_t>(r) * p.S + s] = 0;
  *bodies = total;
  return kOk;
}

}  // namespace

extern "C" int elle_trim_host(const int32_t* in_neigh,
                              const uint8_t* in_mask,
                              const int32_t* out_neigh,
                              const uint8_t* out_mask, const int32_t* inv,
                              const int32_t* comp, const int32_t* proc,
                              const int32_t* ppos, const uint8_t* live0,
                              uint8_t* live_out, int32_t* counts,
                              int32_t* bodies, int n_pad, int d_in,
                              int d_out, int S, int p_pad, int use_rt,
                              int use_proc, int rows) {
  if (!in_neigh || !in_mask || !out_neigh || !out_mask || !inv || !comp ||
      !proc || !ppos || !live0 || !live_out || !counts || !bodies ||
      n_pad < 1 || d_in < 0 || d_out < 0 || S < 1 || p_pad < 1 || rows < 1)
    return kBadArgs;
  const Params p{in_neigh, in_mask, out_neigh, out_mask, inv,  comp,
                 proc,     ppos,    live0,     live_out, counts, n_pad,
                 d_in,     d_out,   S,         p_pad,    use_rt != 0,
                 use_proc != 0, rows};
  try {
    return run(p, bodies);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

extern "C" const char* elle_trim_host_error_string(int code) {
  switch (code) {
    case kOk:
      return "no error";
    case kBadArgs:
      return "bad arguments";
    case kNoMemory:
      return "out of host memory";
    case kNeighborIndex:
      return "neighbor index outside [0, n_pad)";
    case kProcessIndex:
      return "process segment outside [0, p_pad)";
    default:
      return "unknown error";
  }
}
