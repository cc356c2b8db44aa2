"""The Elle device plane, on CUDA: cycle detection as closure kernels.

The port of the JAX package's `jepsen_tpu/elle/tpu.py` (the module
keeps its counterpart's name; nothing here runs on a TPU). Four
hand-written CUDA kernels for the H100 share the query battery, each
beside its plain PyTorch version, which is its spec and what runs on a
CPU tensor:

  bf16    `closure` (`csrc/elle_closure.cu`): the dense (S, N, N)
          transitive closure of A|I by repeated squaring, one bf16
          tensor-core product per squaring with f32 accumulation,
          re-binarized; SCC labels and rw-edge queries from the
          closure. Capacity DEFAULT_MAX_N txns.
  packed  `packed_closure` (`csrc/elle_packed.cu`): the same closure
          over uint32 bitset rows (S, N, N/32), each squaring a Boolean
          product on the tensor cores (`csrc/elle_bitmm.cuh`: 1-bit
          AND/popc wgmma against the bit transpose, zero tiles
          skipped), popcount counters. Bit-identical outputs to bf16;
          capacity PACKED_MAX_N.
  trim    `trim` (`csrc/elle_trim.cu`): peel-to-core cycle existence.
          Per subset, peel every node with no live predecessor or
          successor (sparse ww/wr/rw neighbor lists plus analytic
          realtime/process interval bounds) until the counts repeat; a
          nonempty core <=> a cycle. The CPU route, and what
          `cycle_backend="trim"` forces.
  sharded `sharded_closure` (`csrc/elle_sharded.cu`): the packed
          closure with its W = N/32 word columns split over a device
          list, one block of W/n_shards columns a shard. Before each
          squaring every shard gathers the full reach (the reference's
          `all_gather`: a copy of each block into each shard's gather
          buffer, on the destination's stream); each shard squares its
          own block; the host sums the shards' counts (the reference's
          `psum`) and stops as the packed closure does; the packed
          label pass runs over the final gathered reach. Bit-identical
          outputs to packed; capacity SHARDED_MAX_N.

The subsets ride a leading axis (S = 3: G0's ww graph, G1c's ww+wr,
G2's ww+wr+rw; realtime/process edges join all three). Verdicts come
off the device; explanations stay on the host (BFS restricted to the
flagged component or edge), as in the reference.

Exactness: reach entries are 0/1, exact in bf16, and a sum of at most
n_pad ones is exact in f32, so the bf16 kernel's outputs equal the
reference's f32 run bit for bit; the plain dense version multiplies in
f32.

The warm path is `ops/aot.precompile_elle_closure`. `_squaring_select`
decides bf16 vs packed vs sharded from an analytic byte model against
the cards' memory instead of `Lowered.cost_analysis`.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..fleet import device_labels
from ..ops.wgl32 import _M32, _popcount32, _to_i32
from ..util import (on_device, on_stream, raw_stream, resolve_device,
                    resolve_devices, shard_streams)
from .graph import (PROCESS, REALTIME, RW, WR, WW, DepGraph,
                    _bfs_path)

# The standard Elle query battery (append.clj / wr.clj semantics).
# Subsets are cumulative: S0 (G0) < S1 (G1c, and the G-single closure)
# < S2 (the G2 closure).
SUBSETS = (
    frozenset({WW, REALTIME, PROCESS}),
    frozenset({WW, WR, REALTIME, PROCESS}),
    frozenset({WW, WR, RW, REALTIME, PROCESS}),
)

DEFAULT_MAX_N = 8192
PACKED_MAX_N = 32768
SHARDED_MAX_N = 131072

# degree buckets past this fall back to the dense kernels: a padded
# neighbor gather at that width would cost more than it saves
TRIM_MAX_DEGREE = 256
TRIM_COUNTS_ROWS = 64

# trim's clipped event times and their "absent" sentinel
_BIGI = 2 ** 30
_I32_MAX = 2 ** 31 - 1


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _bucket(n: int) -> int:
    """Next power of two, so shape buckets stay logarithmic in size."""
    return max(1, 1 << (int(n) - 1).bit_length())


def _n_pad_for(n: int) -> int:
    """The dense kernels' shared row padding: pow2 bucket, room for
    the two query-pad sentinels, rounded to a multiple of 128 (the
    dense kernel's tile)."""
    return _round_up(max(_bucket(max(n, 2)), n + 2), 128)


def _launch(name: str, ptrs, ints, dev) -> None:
    from ..ops import _native

    _native.launch(name, [t.data_ptr() for t in ptrs], ints,
                   raw_stream(dev))


def _count(wrapper) -> None:
    """One more launch of a kernel wrapper (its `launches` count)."""
    wrapper.launches += 1


def _squarings(reach, iters: int, square: Callable, on_square=None,
               counts=None):
    """The convergence loop every closure shares (the reference's
    `while_loop`): square until no subset's reach count changed, at
    most `iters` times, at least once. `square(r, counts_row)` returns
    the next reach and writes its per-subset counts into the (S,)
    row; the host reads the row after each squaring (one small copy,
    reported to the compile guard as "elle-square-counts": the
    reference keeps the loop on the device and reads nothing).
    `counts` (iters, S) int32 is allocated on the reach's device unless
    given; a caller that gives host counts reports its own reads.
    Returns (reach, counts, iters_run)."""
    from ..analysis import guards

    note = counts is None
    if counts is None:
        counts = torch.zeros((iters, reach.shape[0]), dtype=torch.int32,
                             device=reach.device)
    prev = None
    i = 0
    while i < iters:
        reach = square(reach, counts[i])
        # kernellint: ok(K007) — per-squaring counts read, a ROADMAP divergence
        c = counts[i].tolist()
        if note:
            guards.note_transfer("d2h", 4 * len(c), what="elle-square-counts")
        if on_square is not None:
            on_square(i, reach)
        i += 1
        if c == prev:
            break
        prev = c
    return reach, counts, i


def _check_closure_inputs(name, tensors, n_pad):
    """The checks before a squaring kernel's launch: one device,
    contiguous, int32 (the dense kernel's weights float32)."""
    dev = tensors[0].device
    if n_pad % 128 or n_pad < 128:
        raise ValueError(f"{name}: n_pad={n_pad} is not a multiple of 128")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype not in (torch.int32, torch.float32):
            raise ValueError(f"{name}: tensor dtype {t.dtype}")


def _check_range(name: str, t: torch.Tensor, hi: int) -> None:
    """Indices a kernel dereferences must lie in [0, hi). On the card the
    two reads are copies, reported to the compile guard as
    "elle-arg-check". A CPU tensor is read through numpy, on this
    thread: torch's reductions there wake its thread pool, whose workers
    then spin beside the host kernel that follows."""
    if not t.numel():
        return
    a = t if t.is_cuda else t.numpy()
    lo, top = int(a.min()), int(a.max())
    if t.is_cuda:
        from ..analysis import guards
        guards.note_transfer("d2h", 4, what="elle-arg-check")
        guards.note_transfer("d2h", 4, what="elle-arg-check")
    if lo < 0 or top >= hi:
        raise ValueError(f"{name}: index outside [0, {hi})")


# -- dense closure: bf16 squaring on the tensor cores ------------------------

def adjacency(src, dst, w, n_pad: int, dtype) -> torch.Tensor:
    """(S, n_pad, n_pad) 0/1 reach seed A|I: `adj.at[:, src, dst].max(w)`
    plus the identity, scattered on the device by indexing. Weights are
    the 0/1 subset memberships (padded edges carry 0), so every write is
    a 1 and duplicates cannot race."""
    S = w.shape[0]
    adj = torch.zeros((S, n_pad, n_pad), dtype=dtype, device=src.device)
    s_idx, e_idx = torch.nonzero(w > 0, as_tuple=True)
    src_l, dst_l = src.long(), dst.long()
    adj[s_idx, src_l[e_idx], dst_l[e_idx]] = 1
    eye = torch.arange(n_pad, device=src.device)
    adj[:, eye, eye] = 1
    return adj


def _labels_ref(rb: torch.Tensor) -> torch.Tensor:
    """labels[s, i] = min{j : R[s,i,j] & R[s,j,i]}, n_pad when none."""
    n_pad = rb.shape[-1]
    cols = torch.arange(n_pad, dtype=torch.int32, device=rb.device)
    out = []
    for s in range(rb.shape[0]):   # one subset at a time bounds memory
        mutual = rb[s] & rb[s].t()
        out.append(torch.where(mutual, cols[None, :],
                               torch.full_like(cols, n_pad)[None, :]
                               ).min(dim=1).values)
    return torch.stack(out)


def dense_square_ref(r: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """One plain squaring: (R @ R > 0) in f32, each subset's count of
    ones into `cnt`."""
    r2 = (torch.bmm(r, r) > 0).to(r.dtype)
    cnt.copy_((r2 > 0).sum(dim=(1, 2), dtype=torch.int32))
    return r2


def closure_ref(src, dst, w, q_src, q_dst, *, n_pad: int, iters: int,
                on_square=None):
    """Plain PyTorch dense closure (the JAX `make_closure_kernel` in
    f32): seed A|I, square (f32 product, re-binarized) until the
    per-subset reach counts repeat or `iters` squarings ran, then SCC
    labels and the rw queries `R[s, q_dst, q_src]`.

    src/dst (e_pad,) int32, w (S, e_pad) float32 0/1, q_src/q_dst
    (q_pad,) int32. Returns (labels (S, n_pad) int32, closed (S, q_pad)
    bool, counts (iters, S) int32, iters_run)."""
    reach = adjacency(src, dst, w, n_pad, torch.float32)
    reach, counts, iters_run = _squarings(reach, iters, dense_square_ref,
                                          on_square)
    rb = reach > 0
    closed = rb[:, q_dst.long(), q_src.long()]
    return _labels_ref(rb), closed, counts, iters_run


def closure(src, dst, w, q_src, q_dst, *, n_pad: int, iters: int,
            on_square=None):
    """The dense closure (see `closure_ref`). CUDA tensors run the
    `elle_closure` kernels: one launch per squaring (bf16 tensor-core
    product, fused binarize + count epilogue) and one for labels and
    queries, each counted in `closure.launches`; CPU tensors run
    `closure_ref`. `on_square(i, reach)` sees the reach after each
    squaring (bf16 here, f32 in the plain version)."""
    dev = src.device
    if dev.type == "cpu":
        return closure_ref(src, dst, w, q_src, q_dst, n_pad=n_pad,
                           iters=iters, on_square=on_square)
    if dev.type != "cuda":
        raise ValueError(f"elle closure: unsupported device {dev}")
    _check_closure_inputs("elle closure", (src, dst, w, q_src, q_dst),
                          n_pad)
    for t in (src, dst, q_src, q_dst):
        _check_range("elle closure", t, n_pad)
    with torch.cuda.device(dev):
        seed = adjacency(src, dst, w, n_pad, torch.bfloat16)
        return _closure_on_card(closure, "elle_closure", seed, q_src, q_dst,
                                n_pad=n_pad, iters=iters, on_square=on_square)


closure.launches = 0


def dense_square(r: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """One squaring (see `dense_square_ref`): the (S, n_pad, n_pad) 0/1
    reach `r` in, (R @ R > 0) out, each subset's count of ones into the
    (S,) int32 `cnt`. A CUDA reach (bf16, contiguous, n_pad a multiple
    of 128) runs one `elle_closure_square` launch into a new buffer,
    counted in `closure.launches`, as a squaring of `closure` is; a CPU
    reach runs the plain version."""
    dev = r.device
    if dev.type == "cpu":
        return dense_square_ref(r, cnt)
    if dev.type != "cuda":
        raise ValueError(f"elle dense_square: unsupported device {dev}")
    S, n_pad = r.shape[0], r.shape[-1]
    if (r.dtype != torch.bfloat16 or r.shape != (S, n_pad, n_pad)
            or not r.is_contiguous() or n_pad % 128 or n_pad < 128
            or cnt.shape != (S,) or cnt.dtype != torch.int32
            or cnt.device != dev):
        raise ValueError("elle dense_square: a contiguous bf16 (S, n, n) "
                         "reach with n a multiple of 128 and an (S,) int32 "
                         f"count on {dev}, got {tuple(r.shape)} {r.dtype}")
    out = torch.empty_like(r)
    cnt.zero_()
    with on_device(dev):
        _launch("elle_closure_square", (r, out, cnt), (S, n_pad), dev)
    _count(closure)
    return out


def _closure_on_card(wrapper, kernel: str, seed, q_src, q_dst, *,
                     n_pad: int, iters: int, on_square, scratch=()):
    """The squaring loop and the label pass of `kernel` ("elle_closure"
    or "elle_packed") on the card, each launch counted on `wrapper`;
    `scratch` follows the count in every squaring's pointers (the
    packed product's `bitmm_scratch`). Squarings alternate between two
    buffers (out of place, as the reference's immutable arrays are:
    squaring in place converges in fewer steps); the seed is left as it
    was."""
    dev = seed.device
    S, q_pad = seed.shape[0], q_src.shape[0]
    spare = [torch.empty_like(seed), torch.empty_like(seed)]

    def square(r, cnt):
        out = spare.pop()
        _launch(f"{kernel}_square", (r, out, cnt, *scratch), (S, n_pad),
                dev)
        _count(wrapper)
        if r is not seed:
            spare.append(r)
        return out

    reach, counts, iters_run = _squarings(seed, iters, square, on_square)
    labels = torch.empty((S, n_pad), dtype=torch.int32, device=dev)
    closed = torch.empty((S, q_pad), dtype=torch.bool, device=dev)
    _launch(f"{kernel}_labels", (reach, q_src, q_dst, labels, closed),
            (S, n_pad, q_pad), dev)
    _count(wrapper)
    return labels, closed, counts, iters_run


# -- packed closure: uint32 bitset squaring ----------------------------------

def _bits(dev) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=dev)


def unpack_bits(r: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words holding uint32 bit patterns -> (..., 32 W)
    bools, bit k of word w at column 32 w + k."""
    words = r.to(torch.int64) & _M32
    b = (words[..., None] >> _bits(r.device)) & 1
    return b.reshape(*r.shape[:-1], r.shape[-1] * 32).bool()


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """unpack_bits' inverse: (..., 32 W) bools -> (..., W) int32."""
    v = b.reshape(*b.shape[:-1], b.shape[-1] // 32, 32).to(torch.int64)
    return _to_i32((v << _bits(b.device)).sum(dim=-1))


def packed_r0(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
              n_pad: int) -> np.ndarray:
    """The packed reach seed A|I, assembled on the host with one
    bitwise_or scatter per subset (as the reference does): (S, n_pad,
    n_pad / 32) uint32."""
    n_sub = w.shape[0]
    r0 = np.zeros((n_sub, n_pad, n_pad // 32), np.uint32)
    eye = np.arange(n_pad)
    np.bitwise_or.at(r0, (slice(None), eye, eye // 32),
                     np.uint32(1) << (eye % 32).astype(np.uint32))
    for si in range(n_sub):
        m = w[si] > 0
        if m.any():
            np.bitwise_or.at(
                r0[si], (src[m], dst[m] // 32),
                np.uint32(1) << (dst[m] % 32).astype(np.uint32))
    return r0


def packed_square_ref(r: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """One plain packed squaring, R2[s,i] = OR_{j : R[s,i] bit j}
    R[s,j], computed one subset at a time through the unpacked 0/1
    product (exact in f32: sums of at most n_pad ones); `cnt` gets each
    subset's popcount."""
    out = torch.empty_like(r)
    for s in range(r.shape[0]):
        rb = unpack_bits(r[s]).to(torch.float32)
        out[s] = pack_bits(torch.mm(rb, rb) > 0)
        del rb
    cnt.copy_(_popcount32(out.to(torch.int64) & _M32).sum(
        dim=(1, 2)).to(torch.int32))
    return out


# The tensor-core product's tiles (csrc/elle_bitmm.cuh): 128 rows of A
# by 256 columns of the output (rows of the bit transpose) by 1024 bits
# of k (32 words) a stage; its skip flags are kept per 128-row tile of
# A and per 256-row tile of the transpose, each per 32-word k stage.
BITMM_ROWS = 128
BITMM_COLS = 256
BITMM_K_WORDS = 32


def bit_transpose_ref(b: torch.Tensor) -> torch.Tensor:
    """The bit transpose of a packed (S, n, w) block: (S, 32 w, n / 32)
    int32 words, row c the bits of column c of `b` (bit j of row c's
    word j / 32 is row j's bit c)."""
    return torch.stack([pack_bits(unpack_bits(b[s]).t().contiguous())
                        for s in range(b.shape[0])])


def tile_flags_ref(x: torch.Tensor, rows: int,
                   words: int = BITMM_K_WORDS) -> torch.Tensor:
    """(S, ceil(R / rows), ceil(Wd / words)) uint8: 1 where the tile of
    `rows` rows x `words` words of the (S, R, Wd) plane `x` holds a bit
    (tiles past the plane's edge count its part inside)."""
    S, R, Wd = x.shape
    pad = torch.zeros((S, -(-R // rows) * rows, -(-Wd // words) * words),
                      dtype=x.dtype, device=x.device)
    pad[:, :R, :Wd] = x
    t = pad.view(S, pad.shape[1] // rows, rows, pad.shape[2] // words,
                 words)
    return (t != 0).any(dim=4).any(dim=2).to(torch.uint8)


def bitmm_flags_ref(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The product's flag planes for A = `a` and B = `b` ((S, n, w)
    words): `tile_flags_ref(a, BITMM_ROWS)`, and the T tile flags read
    off B's own tiles (a 256-row x 32-word tile of B's transpose holds
    a bit exactly when the 1024 rows x 8 words of B behind it do), so no
    transpose is made."""
    return (tile_flags_ref(a, BITMM_ROWS),
            tile_flags_ref(b, 32 * BITMM_K_WORDS, BITMM_COLS // 32)
            .transpose(1, 2).contiguous())


def bitmm_ref(a: torch.Tensor, t: torch.Tensor, fa: torch.Tensor,
              fb: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The squaring as the tensor-core kernel computes it, in plain
    PyTorch: out[s,i,c] = (sum over the k stages whose A tile and T tile
    are both flagged of popc(A row i AND T row c)) > 0, packed into (S,
    n, n_cols / 32) words, with `a` the (S, n, n / 32) bit rows, `t`
    the (S, n_cols, n / 32) transpose of B (`bit_transpose_ref`), `fa` =
    `tile_flags_ref(a, BITMM_ROWS)` and `fb` = `tile_flags_ref(t,
    BITMM_COLS)`; `cnt` gets each subset's popcount. Skipping a stage
    whose tile has no bit drops only zero terms, so this equals
    `packed_square_ref` (A = B = R) and `sharded_square_ref` (A the
    gathered reach, B the block)."""
    S, n, W = a.shape
    n_cols = t.shape[1]
    out = torch.empty((S, n, n_cols // 32), dtype=torch.int32,
                      device=a.device)
    for s in range(S):
        acc = torch.zeros((n, n_cols), dtype=torch.float32, device=a.device)
        for kb in range(fa.shape[2]):
            k = slice(kb * BITMM_K_WORDS, (kb + 1) * BITMM_K_WORDS)
            on = (fa[s, :, kb].repeat_interleave(BITMM_ROWS)[:n, None].bool()
                  & fb[s, :, kb].repeat_interleave(BITMM_COLS)[None, :n_cols]
                  .bool())
            acc += torch.mm(unpack_bits(a[s, :, k]).to(torch.float32),
                            unpack_bits(t[s, :, k]).to(torch.float32).t()) * on
        out[s] = pack_bits(acc > 0)
    cnt.copy_(_popcount32(out.to(torch.int64) & _M32).sum(
        dim=(1, 2)).to(torch.int32))
    return out


def bitmm_scratch_shapes(S: int, n_pad: int, w: int) -> tuple:
    """(shape, dtype) of each buffer of the tensor-core squaring's
    scratch for B of w words a row (w = n_pad / 32 packed, w_loc a
    shard): the bit transpose (S, 32 w, n_pad / 32) int32, the A tile
    flags (S, n_pad / 128, K) and the T tile flags (S, ceil(32 w / 256),
    K) uint8, K = ceil(n_pad / 1024) k stages."""
    W = n_pad // 32
    K = -(-W // BITMM_K_WORDS)
    return (((S, 32 * w, W), torch.int32),
            ((S, n_pad // BITMM_ROWS, K), torch.uint8),
            ((S, -(-32 * w // BITMM_COLS), K), torch.uint8))


def bitmm_scratch(S: int, n_pad: int, w: int, device) -> tuple:
    """The buffers of `bitmm_scratch_shapes`, allocated on the current
    stream."""
    return tuple(torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in bitmm_scratch_shapes(S, n_pad, w))


def _check_scratch(name: str, scratch: tuple, S: int, n_pad: int, w: int,
                   dev) -> None:
    """A caller's scratch must be `bitmm_scratch(S, n_pad, w, dev)`'s
    buffers: the kernel writes them up to those sizes unchecked."""
    shapes = bitmm_scratch_shapes(S, n_pad, w)
    if len(scratch) != len(shapes) or any(
            tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
            or not t.is_contiguous()
            for t, (shape, dtype) in zip(scratch, shapes)):
        raise ValueError(f"{name}: scratch must be bitmm_scratch({S}, "
                         f"{n_pad}, {w}) on {dev}")


def packed_square(r: torch.Tensor, cnt: torch.Tensor,
                  scratch: Optional[tuple] = None) -> torch.Tensor:
    """One packed squaring (see `packed_square_ref`): the (S, n_pad,
    n_pad / 32) int32 reach `r` in, a new reach out, each subset's
    popcount into the (S,) int32 `cnt`. A CUDA reach runs one
    `elle_packed_square` launch (the tensor-core product over
    `scratch`, a `bitmm_scratch` made here when None), counted in
    `packed_closure.launches` as a squaring of `packed_closure` is; a
    CPU reach runs the plain version. A given scratch is checked on
    either device."""
    dev = r.device
    S, n_pad = r.shape[0], r.shape[1]
    if scratch is not None:
        _check_scratch("elle packed_square", scratch, S, n_pad, n_pad // 32,
                       dev)
    if dev.type == "cpu":
        return packed_square_ref(r, cnt)
    if dev.type != "cuda":
        raise ValueError(f"elle packed_square: unsupported device {dev}")
    _check_closure_inputs("elle packed_square", (r, cnt), n_pad)
    if tuple(r.shape) != (S, n_pad, n_pad // 32) or r.dtype != torch.int32 \
            or tuple(cnt.shape) != (S,) or cnt.dtype != torch.int32:
        raise ValueError("elle packed_square: an (S, n, n / 32) int32 reach "
                         "and an (S,) int32 count")
    out = torch.empty_like(r)
    cnt.zero_()
    with on_device(dev):
        if scratch is None:
            scratch = bitmm_scratch(S, n_pad, n_pad // 32, dev)
        _launch("elle_packed_square", (r, out, cnt, *scratch), (S, n_pad),
                dev)
    _count(packed_closure)
    return out


def packed_labels_ref(reach, q_src, q_dst):
    """Labels and rw queries from a packed closure (the reference's
    label scan over 32-column blocks, as one mutual-reach min)."""
    labels = torch.stack([_labels_ref(unpack_bits(reach[s])[None])[0]
                          for s in range(reach.shape[0])])
    qs, qd = q_src.long(), q_dst.long()
    words = reach[:, qd, qs // 32].to(torch.int64) & _M32
    closed = ((words >> (qs % 32)) & 1) > 0
    return labels, closed


def packed_closure_ref(r0, q_src, q_dst, *, n_pad: int, iters: int,
                       on_square=None):
    """Plain PyTorch packed closure (the JAX
    `make_packed_closure_kernel`): r0 (S, n_pad, n_pad/32) int32 words
    of the uint32 bitset rows. Same outputs as `closure_ref` on the
    same graph, bit for bit."""
    reach, counts, iters_run = _squarings(r0, iters, packed_square_ref,
                                          on_square)
    labels, closed = packed_labels_ref(reach, q_src, q_dst)
    return labels, closed, counts, iters_run


def packed_closure(r0, q_src, q_dst, *, n_pad: int, iters: int,
                   on_square=None):
    """The packed closure (see `packed_closure_ref`). CUDA tensors run
    the `elle_packed` kernels (one launch per squaring, over one
    `bitmm_scratch` the squarings share, and one for labels and
    queries; counted in `packed_closure.launches`); CPU tensors run
    `packed_closure_ref`. r0 is not modified."""
    dev = r0.device
    if dev.type == "cpu":
        return packed_closure_ref(r0, q_src, q_dst, n_pad=n_pad,
                                  iters=iters, on_square=on_square)
    if dev.type != "cuda":
        raise ValueError(f"elle packed closure: unsupported device {dev}")
    _check_closure_inputs("elle packed closure", (r0, q_src, q_dst), n_pad)
    if tuple(r0.shape[1:]) != (n_pad, n_pad // 32) or r0.dtype != torch.int32:
        raise ValueError("elle packed closure: r0 must be (S, n_pad, "
                         "n_pad / 32) int32")
    for t in (q_src, q_dst):
        _check_range("elle packed closure", t, n_pad)
    with torch.cuda.device(dev):
        return _closure_on_card(
            packed_closure, "elle_packed", r0, q_src, q_dst, n_pad=n_pad,
            iters=iters, on_square=on_square,
            scratch=bitmm_scratch(r0.shape[0], n_pad, n_pad // 32, dev))


packed_closure.launches = 0


# -- sharded closure: word columns over a device list ------------------------

def shard_blocks(r0: torch.Tensor, n_shards: int) -> list:
    """The (S, n_pad, W) packed reach cut into `n_shards` contiguous
    column blocks of W / n_shards words (copies), block k for shard k."""
    w = r0.shape[-1] // n_shards
    if w * n_shards != r0.shape[-1]:
        raise ValueError(f"W {r0.shape[-1]} not divisible by {n_shards} "
                         "shards")
    return [r0[..., k * w:(k + 1) * w].contiguous() for k in range(n_shards)]


def sharded_square_ref(full: torch.Tensor, loc: torch.Tensor,
                       cnt: torch.Tensor) -> torch.Tensor:
    """One plain squaring of a word-column shard (`packed_square_ref`
    restricted to the shard's columns): out[s,i] = OR_{j : full[s,i]
    bit j} loc[s,j], `full` the gathered (S, n_pad, W) reach and `loc`
    the shard's (S, n_pad, w_loc) block; `cnt` gets each subset's
    popcount of the new block."""
    out = torch.empty_like(loc)
    for s in range(loc.shape[0]):
        bits = unpack_bits(full[s]).to(torch.float32)
        out[s] = pack_bits(torch.mm(bits, unpack_bits(loc[s]).to(
            torch.float32)) > 0)
        del bits
    cnt.copy_(_popcount32(out.to(torch.int64) & _M32).sum(
        dim=(1, 2)).to(torch.int32))
    return out


def sharded_square(full: torch.Tensor, loc: torch.Tensor, cnt: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   scratch: Optional[tuple] = None) -> torch.Tensor:
    """One squaring of a word-column shard (see `sharded_square_ref`),
    into `out` (a new tensor when None). CUDA tensors run the
    `elle_sharded_square` kernel on the current stream (one launch per
    call, counted in `sharded_square.launches`; `cnt` must be zero, the
    kernel adds to it), the tensor-core product over `scratch` (a
    `bitmm_scratch` of the block's width, made here when None, and
    checked on either device when given); CPU tensors run
    `sharded_square_ref`."""
    dev = loc.device
    S, n_pad, w_loc = loc.shape
    if scratch is not None:
        _check_scratch("elle sharded square", scratch, S, n_pad, w_loc, dev)
    if dev.type == "cpu":
        r = sharded_square_ref(full, loc, cnt)
        if out is None:
            return r
        return out.copy_(r)
    if dev.type != "cuda":
        raise ValueError(f"elle sharded square: unsupported device {dev}")
    out = torch.empty_like(loc) if out is None else out
    if n_pad % 128 or tuple(full.shape) != (S, n_pad, n_pad // 32) \
            or tuple(out.shape) != tuple(loc.shape) \
            or tuple(cnt.shape) != (S,) or (n_pad // 32) % w_loc:
        raise ValueError("elle sharded square: full (S, n, n / 32), loc and "
                         "out (S, n, w_loc) with w_loc | n / 32, cnt (S,)")
    for t in (full, loc, out, cnt):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("elle sharded square: contiguous int32 tensors "
                             f"on {dev}")
    if scratch is None:
        scratch = bitmm_scratch(S, n_pad, w_loc, dev)
    _launch("elle_sharded_square", (full, loc, out, cnt, *scratch),
            (S, n_pad, w_loc), dev)
    _count(sharded_square)
    return out


sharded_square.launches = 0


def sharded_closure_ref(blocks, q_src, q_dst, *, n_pad: int, iters: int,
                        on_square=None):
    """Plain PyTorch sharded closure (the JAX
    `make_sharded_closure_kernel`): `blocks` are the shards' (S, n_pad,
    w_loc) int32 column blocks (`shard_blocks`). Each squaring gathers
    the full reach, squares every block against it and sums the
    shards' counts; labels and rw queries come from the final gathered
    reach. `on_square(i, blocks)` sees the blocks after each squaring.
    Returns `packed_closure_ref`'s (labels, closed, counts, iters_run),
    bit for bit."""
    from ..analysis import guards

    S = blocks[0].shape[0]

    def square(bl, cnt):
        full = torch.cat(bl, dim=2)
        parts = torch.zeros((len(bl), S), dtype=torch.int32)
        out = [sharded_square_ref(full, b, parts[k])
               for k, b in enumerate(bl)]
        cnt.copy_(parts.sum(dim=0, dtype=torch.int32))
        # one count read a shard, as on the card
        for _ in bl:
            guards.note_transfer("d2h", 4 * S, what="elle-square-counts")
        return out

    blocks, counts, iters_run = _squarings(
        list(blocks), iters, square, on_square,
        counts=torch.zeros((iters, S), dtype=torch.int32))
    labels, closed = packed_labels_ref(torch.cat(blocks, dim=2), q_src,
                                       q_dst)
    return labels, closed, counts, iters_run


def sharded_closure(blocks, q_src, q_dst, *, n_pad: int, iters: int,
                    on_square=None):
    """The sharded closure (see `sharded_closure_ref`). `blocks[k]` lies
    on shard k's device (a card may hold several shards); `q_src` and
    `q_dst` on shard 0's. CUDA blocks run the `elle_sharded_square`
    kernel (`sharded_square`), one launch per shard per squaring, each
    shard on its own stream; before
    each squaring every shard's block is copied into every shard's
    gather buffer on the destination's stream, after the source's
    squaring; the host then sums the shards' counts. The label pass is
    `elle_packed_labels` over shard 0's final gather (counted in
    `packed_closure.launches`, the packed kernels' wrapper). CPU blocks
    run `sharded_closure_ref`. The blocks are not modified. Returns
    (labels, closed, counts (iters, S) on the host, iters_run)."""
    devs = [b.device for b in blocks]
    if all(d.type == "cpu" for d in devs):
        return sharded_closure_ref(blocks, q_src, q_dst, n_pad=n_pad,
                                   iters=iters, on_square=on_square)
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"elle sharded closure: devices {devs}")
    S, n_sh, W = blocks[0].shape[0], len(blocks), n_pad // 32
    w_loc = W // n_sh
    if w_loc * n_sh != W or n_pad % 128 or n_pad < 128:
        raise ValueError(f"elle sharded closure: n_pad {n_pad} over "
                         f"{n_sh} shards")
    for b in blocks:
        if tuple(b.shape) != (S, n_pad, w_loc) or b.dtype != torch.int32 \
                or not b.is_contiguous():
            raise ValueError("elle sharded closure: blocks must be (S, "
                             "n_pad, W / n_shards) contiguous int32")
    _check_closure_inputs("elle sharded closure", (q_src, q_dst), n_pad)
    if q_src.device != devs[0] or q_dst.device != devs[0]:
        raise ValueError("elle sharded closure: queries on shard 0's "
                         "device")
    for t in (q_src, q_dst):
        _check_range("elle sharded closure", t, n_pad)
    from ..analysis import guards

    streams = shard_streams(devs)
    # the blocks and queries were written on the callers' streams
    for k, dev in enumerate(devs):
        streams[k].wait_stream(torch.cuda.current_stream(dev))
    ready = []                      # the event after each shard's write
    full, spare, scratch, cnts = [], [], [], []
    for k, dev in enumerate(devs):
        with torch.cuda.device(dev), on_stream(streams[k]):
            full.append(torch.empty((S, n_pad, W), dtype=torch.int32,
                                    device=dev))
            spare.append([torch.empty_like(blocks[k]),
                          torch.empty_like(blocks[k])])
            scratch.append(bitmm_scratch(S, n_pad, w_loc, dev))
            cnts.append(torch.empty(S, dtype=torch.int32, device=dev))
            ev = torch.cuda.Event()
            ev.record(streams[k])
            ready.append(ev)

    def gather(bl, dst: int) -> None:
        with torch.cuda.device(devs[dst]), on_stream(streams[dst]):
            for k, b in enumerate(bl):
                streams[dst].wait_event(ready[k])
                full[dst][..., k * w_loc:(k + 1) * w_loc].copy_(b)

    def square(bl, cnt):
        for d in range(n_sh):
            gather(bl, d)
        out = []
        for d, dev in enumerate(devs):
            with torch.cuda.device(dev), on_stream(streams[d]):
                cnts[d].zero_()
                o = sharded_square(full[d], bl[d], cnts[d],
                                   out=spare[d].pop(), scratch=scratch[d])
                ready[d].record(streams[d])
            if bl[d] is not blocks[d]:
                spare[d].append(bl[d])
            out.append(o)
        total = [0] * S
        for d in range(n_sh):
            # kernellint: ok(K007) — per-squaring counts, a ROADMAP divergence
            ready[d].synchronize()
            total = [a + b for a, b in zip(total, cnts[d].tolist())]
            guards.note_transfer("d2h", 4 * S, what="elle-square-counts")
        cnt.copy_(torch.tensor(total, dtype=torch.int32))
        return out

    bl, counts, iters_run = _squarings(
        list(blocks), iters, square, on_square,
        counts=torch.zeros((iters, S), dtype=torch.int32))
    dev0 = devs[0]
    gather(bl, 0)
    with torch.cuda.device(dev0), on_stream(streams[0]):
        labels = torch.empty((S, n_pad), dtype=torch.int32, device=dev0)
        closed = torch.empty((S, q_src.shape[0]), dtype=torch.bool,
                             device=dev0)
        _launch("elle_packed_labels", (full[0], q_src, q_dst, labels, closed),
                (S, n_pad, q_src.shape[0]), dev0)
        _count(packed_closure)
    # nothing of this call may still run when its buffers are freed
    # kernellint: ok(K001) — one wait a closure, not one a squaring
    streams[0].synchronize()
    for t in (labels, closed):
        t.record_stream(torch.cuda.current_stream(dev0))
    return labels, closed, counts, iters_run


# -- trim: peel-to-core cycle detection + interval jumps ---------------------

def _peel_ref(live, in_neigh, in_mask, out_neigh, out_mask, inv_e, comp_e,
              proc, ppos, *, p_pad, use_rt, use_proc):
    """One peel round of the JAX `make_trim_kernel` (live (n_pad, S)
    bools): a node survives with a live predecessor AND a live
    successor, from the neighbor lists, the process chains and the
    anchored realtime thresholds."""
    has_in = (live[in_neigh.long()] & in_mask).any(dim=1)
    has_out = (live[out_neigh.long()] & out_mask).any(dim=1)
    n_pad, S = live.shape
    pp = ppos[:, None].expand(n_pad, S)
    if use_proc:
        seg = proc.long()[:, None].expand(n_pad, S)
        big = torch.full_like(pp, _BIGI)
        minpp = torch.full((p_pad, S), _I32_MAX, dtype=torch.int32,
                           device=live.device).scatter_reduce(
            0, seg, torch.where(live, pp, big), "amin")
        maxpp = torch.full((p_pad, S), -_I32_MAX - 1, dtype=torch.int32,
                           device=live.device).scatter_reduce(
            0, seg, torch.where(live, pp, -big), "amax")
        has_in = has_in | (pp > minpp[proc.long()])
        has_out = has_out | ((pp < maxpp[proc.long()]) & (pp >= 0))
    if use_rt:
        rows = torch.arange(n_pad, device=live.device)[:, None]
        inverted = (comp_e < inv_e)[:, None]
        comp_pool = torch.where(live & (has_in | inverted),
                                comp_e[:, None], _BIGI)
        minc1, minc_at = comp_pool.min(dim=0).values, comp_pool.argmin(0)
        minc2 = torch.where(rows == minc_at[None, :], _BIGI,
                            comp_pool).min(dim=0).values
        inv_pool = torch.where(live & (has_out | inverted),
                               inv_e[:, None], -_BIGI)
        maxi1, maxi_at = inv_pool.max(dim=0).values, inv_pool.argmax(0)
        maxi2 = torch.where(rows == maxi_at[None, :], -_BIGI,
                            inv_pool).max(dim=0).values
        in_thr = torch.where(rows == minc_at[None, :], minc2[None, :],
                             minc1[None, :])
        out_thr = torch.where(rows == maxi_at[None, :], maxi2[None, :],
                              maxi1[None, :])
        has_in = has_in | (inv_e[:, None] > in_thr)
        has_out = has_out | (comp_e[:, None] < out_thr)
    return live & has_in & has_out


def trim_ref(in_neigh, in_mask, out_neigh, out_mask, inv_e, comp_e, proc,
             ppos, live0, *, p_pad: int, use_rt: bool, use_proc: bool,
             counts_rows: int = TRIM_COUNTS_ROWS):
    """Plain PyTorch trim fixpoint (the JAX `make_trim_kernel`): two
    peels per body until no subset's live count changed, at most n_pad
    bodies; counts row min(i, counts_rows - 1) holds body i's counts.

    in_neigh (n_pad, d_in) int32, in_mask (n_pad, d_in, S) bool, the
    same for out; inv_e/comp_e/proc/ppos (n_pad,) int32; live0 (n_pad,
    S) bool. Returns (live (n_pad, S) bool, counts (counts_rows, S)
    int32, bodies)."""
    n_pad, S = live0.shape
    kw = dict(p_pad=p_pad, use_rt=use_rt, use_proc=use_proc)
    args = (in_neigh, in_mask, out_neigh, out_mask, inv_e, comp_e, proc,
            ppos)
    counts = torch.zeros((counts_rows, S), dtype=torch.int32,
                         device=live0.device)
    live = live0
    prev = None
    i = 0
    while i < n_pad:
        live = _peel_ref(_peel_ref(live, *args, **kw), *args, **kw)
        c = live.sum(dim=0, dtype=torch.int32)
        counts[min(i, counts_rows - 1)] = c
        # kernellint: ok(K007) — the plain version's fixpoint test
        c = c.tolist()
        i += 1
        if c == prev:
            break
        prev = c
    return live, counts, i


# the process segments `csrc/elle_trim.cu` keeps in shared memory (its
# kSmemProcs); past them its segment buffers live in the scratch
TRIM_SMEM_PROCS = 4096


def trim_scratch_words(n_pad: int, slots: int, S: int, p_pad: int,
                       use_proc: bool) -> int:
    """int32 words of the trim kernel's scratch (`csrc/elle_trim.cu`):
    [ticket, bodies per subset] padded to an even count, then per subset
    the sort keys (n_pad uint64), the ends of the transposed lists (2
    n_pad), the two row orders (2 n_pad), the lists' uint16 entries (one
    a masked slot: `slots`, the slots of both lists masked in any
    subset, in an even count of words) and, with the process chains on
    past TRIM_SMEM_PROCS segments, the two segment buffers (4 p_pad)."""
    per = 6 * n_pad + (slots + 3) // 4 * 2
    if use_proc and p_pad > TRIM_SMEM_PROCS:
        per += 4 * p_pad
    return (S + 2) // 2 * 2 + S * per


def trim(in_neigh, in_mask, out_neigh, out_mask, inv_e, comp_e, proc, ppos,
         live0, *, p_pad: int, use_rt: bool, use_proc: bool,
         counts_rows: int = TRIM_COUNTS_ROWS):
    """The trim fixpoint (see `trim_ref`). CUDA tensors run the
    `elle_trim` kernel (one launch per call, counted in
    `trim.launches`; the whole fixpoint runs on the device); CPU tensors
    run the host kernel `elle_trim_host` (`csrc/elle_trim_host.cpp`, one
    call, counted in `trim.host_calls`)."""
    dev = live0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"elle trim: unsupported device {dev}")
    args = (in_neigh, in_mask, out_neigh, out_mask, inv_e, comp_e, proc,
            ppos, live0)
    n_pad, S = live0.shape
    d_in, d_out = in_neigh.shape[1], out_neigh.shape[1]
    want = ((n_pad, d_in), (n_pad, d_in, S), (n_pad, d_out),
            (n_pad, d_out, S), (n_pad,), (n_pad,), (n_pad,), (n_pad,),
            (n_pad, S))
    types = (torch.int32, torch.bool) * 2 + (torch.int32,) * 4 + (
        torch.bool,)
    for t, shape, dt in zip(args, want, types):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"elle trim: got {tuple(t.shape)} {t.dtype}, "
                             f"want {shape} {dt}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("elle trim: tensors must be contiguous on "
                             f"{dev}")
    if max(d_in, d_out) > TRIM_MAX_DEGREE:
        # the kernel packs a node's in- and out-counts in 16 bits each
        raise ValueError(f"elle trim: degree buckets {d_in}, {d_out} past "
                         f"{TRIM_MAX_DEGREE}")
    if n_pad > PACKED_MAX_N or n_pad < 128 or n_pad & (n_pad - 1) or \
            p_pad < 1 or counts_rows < 1:
        raise ValueError(f"elle trim: n_pad={n_pad} p_pad={p_pad} "
                         f"counts_rows={counts_rows} out of range")
    _check_range("elle trim", in_neigh, n_pad)
    _check_range("elle trim", out_neigh, n_pad)
    _check_range("elle trim", proc, p_pad)
    ints = (n_pad, d_in, d_out, S, p_pad, int(use_rt), int(use_proc),
            counts_rows)
    live = torch.empty_like(live0)
    counts = torch.empty((counts_rows, S), dtype=torch.int32, device=dev)
    bodies = torch.empty((), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        from ..ops import _native

        _native.host_call("elle_trim_host", [
            t.data_ptr() for t in args + (live, counts, bodies)], ints)
        trim.host_calls += 1
    else:
        from ..analysis import guards

        with torch.cuda.device(dev):
            # the transposes hold one entry a masked slot
            # kernellint: ok(K001) — the masked slots size the scratch
            slots = int(in_mask.any(dim=2).sum()) + int(
                out_mask.any(dim=2).sum())
            guards.note_transfer("d2h", 8, what="elle-arg-check")
            # [ticket, bodies per subset] zeroed; the rest the kernel
            # writes
            scratch = torch.empty(trim_scratch_words(n_pad, slots, S, p_pad,
                                                     use_proc),
                                  dtype=torch.int32, device=dev)
            scratch[:1 + S].zero_()
            _launch("elle_trim", args + (live, counts, bodies, scratch),
                    ints + (slots,), dev)
            _count(trim)
        # the body count's read (the reference reads it uncounted)
        guards.note_transfer("d2h", 4, what="elle-trim-bodies")
    # kernellint: ok(K001) — the bodies count the result reports
    return live, counts, int(bodies)


trim.launches = 0
trim.host_calls = 0


# -- host halves -------------------------------------------------------------

def _graph_arrays(g, subsets, rw_type):
    """Shared edge-column prep for the squaring kernels: local ids,
    per-subset weights, rw query endpoints."""
    nodes = g.nodes
    n = int(nodes.shape[0])
    edges = np.asarray(g.edges)
    id_of = {int(v): i for i, v in enumerate(nodes)}
    src = np.array([id_of[int(s)] for s in edges[:, 0]], np.int32)
    dst = np.array([id_of[int(d)] for d in edges[:, 1]], np.int32)
    typ = edges[:, 2]
    n_sub = len(subsets)
    w = np.zeros((n_sub, len(src)), np.float32)
    for si, sub in enumerate(subsets):
        w[si] = np.isin(typ, list(sub)).astype(np.float32)
    rw_mask = typ == rw_type
    q_src, q_dst = src[rw_mask], dst[rw_mask]
    rw_edges = [(int(edges[i, 0]), int(edges[i, 1]))
                for i in np.flatnonzero(rw_mask)]
    return nodes, n, src, dst, w, q_src, q_dst, rw_edges


def _sccs_from_labels(labels, nodes, n, n_sub):
    sccs: list = []
    for si in range(n_sub):
        comps: dict = {}
        for i in range(n):
            lab = int(labels[si, i])
            if lab != i:
                comps.setdefault(lab, [int(nodes[lab])]).append(
                    int(nodes[i]))
        sccs.append([sorted(c) for c in comps.values()])
    return sccs


def _pad(a, size, fill):
    out = np.full(size, fill, np.int32)
    out[:len(a)] = a
    return out


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _upload(arrays, dev) -> list:
    """The kernel inputs on `dev`, reported to the compile guard as one
    upload ("elle-closure-inputs", as the reference does)."""
    from ..analysis import guards

    ins = [_tensor(a, dev) for a in arrays]
    guards.note_transfer("h2d", sum(int(np.asarray(a).nbytes)
                                    for a in arrays),
                         what="elle-closure-inputs")
    return ins


def _note_outputs(*arrays) -> None:
    """The kernel outputs' copy to the host, one download
    ("elle-closure-outputs", as the reference does)."""
    from ..analysis import guards

    guards.note_transfer("d2h", sum(int(a.nbytes) for a in arrays),
                         what="elle-closure-outputs")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reach_util(iter_counts, iters, iters_run, n_pad) -> dict:
    """The occupancy block both squaring kernels report: reach counts
    per executed squaring and where the widest subset stopped growing."""
    iter_counts = np.asarray(iter_counts)[:iters_run]
    widest = iter_counts[:, -1]
    converged_at = int(iters_run)
    for i in range(1, iters_run):
        if widest[i] == widest[i - 1]:
            converged_at = i
            break
    return {"n_pad": n_pad, "iters": iters, "iters_run": iters_run,
            "iters_reclaimed": int(iters) - iters_run,
            "iter_reach": [[int(v) for v in row] for row in iter_counts],
            "converged_at": converged_at,
            "reach_density": round(
                float(widest[-1]) / float(n_pad) ** 2, 6)}


def closure_inputs(g, subsets: Sequence[frozenset] = SUBSETS,
                   rw_type: int = RW, packed: bool = False) -> dict:
    """The squaring kernels' padded inputs for `g`, as numpy arrays:
    `closure`'s (src, dst, w, q_src, q_dst) or, with `packed`,
    `packed_closure`'s (r0, q_src, q_dst), under "args"; with the
    shapes (n, n_pad, iters) and what the host needs back (nodes,
    rw_edges, edges). Padding nodes are isolated, and n_pad >= n + 2
    leaves two distinct ones for the padded (always-False) queries."""
    nodes, n, src, dst, w, q_src, q_dst, rw_edges = \
        _graph_arrays(g, subsets, rw_type)
    n_pad = _n_pad_for(n)
    q_pad = _bucket(max(len(q_src), 1))
    queries = (_pad(q_src, q_pad, n_pad - 1), _pad(q_dst, q_pad, n_pad - 2))
    if packed:
        args = (packed_r0(src, dst, w, n_pad).view(np.int32),) + queries
    else:
        e_pad = _bucket(max(len(src), 1))
        w_p = np.zeros((len(subsets), e_pad), np.float32)
        w_p[:, :w.shape[1]] = w
        args = (_pad(src, e_pad, 0), _pad(dst, e_pad, 0), w_p) + queries
    return {"args": args, "n": n, "n_pad": n_pad,
            "iters": max(1, math.ceil(math.log2(n_pad))),
            "nodes": nodes, "rw_edges": rw_edges, "edges": len(src)}


def _hbm_close(util: dict, dm, dmark, devices) -> None:
    """Close the window onto the util block: `hbm` the measured block
    (the explicit stats_unavailable marker on the CPU),
    `hbm_peak_measured` its peak."""
    if dmark is None:
        return
    block = dm.measured(dmark, where="elle-closure", devices=devices)
    util["hbm"] = block
    if block.get("peak_measured") is not None:
        util["hbm_peak_measured"] = block["peak_measured"]


def _watched(fn, devices, **progress):
    """`fn()` (one closure call on `devices`) in a device-monitor window
    and under a watchdog source, as the reference has them: the closure
    has no poll loop to beat from, so the one beat lands before the
    call, and only a multi-minute silence is a hang. Returns (fn's
    result, the monitor, the window's token: None when the monitor is
    off)."""
    from .. import devices as _devices
    from .. import watchdog as _watchdog
    wd = _watchdog.get_default()
    dm = _devices.get_default()
    dmark = dm.mark(where="elle-closure", devices=devices) \
        if dm.enabled else None
    with wd.watch("elle-closure", device=str(devices[0]),
                  stall_s=300.0) as hb:
        wd.beat(hb, **progress)
        out = fn()
    return out, dm, dmark


def _record_closure(util: dict, edges: int, n: int) -> None:
    """The `elle_closure` series, `elle_closure_calls_total` and the
    `elle_closure_seconds` histogram (metrics on), and an `elle` strip on
    the live occupancy block (status on), under the reference's names;
    every device closure variant records here."""
    from .. import fleet as _fleet
    from .. import metrics as _metrics
    mx = _metrics.get_default()
    if mx.enabled:
        mx.series("elle_closure",
                  "per-call Elle closure-kernel telemetry").append(
            {"edges": int(edges), "n": int(n), **util})
        mx.counter("elle_closure_calls_total",
                   "batched closure kernel invocations").inc()
        mx.histogram("elle_closure_seconds",
                     "closure kernel wall (post-compile)").observe(
            float(util.get("kernel_s") or 0.0))
    st = _fleet.get_default()
    if st.enabled:
        st.occupancy_poll({"elle": {
            "kernel": util.get("kernel", "bf16"), "n": int(n),
            "edges": int(edges), "iters_run": util.get("iters_run"),
            "kernel_s": util.get("kernel_s"),
            "reach_density": util.get("reach_density")}},
            search_id="elle")


def _run_closure(g, subsets, rw_type, max_n, device, packed):
    """cycle_queries / cycle_queries_packed: the closure of `g` on
    `device`, its sccs and rw answers, and the occupancy block."""
    if int(np.asarray(g.nodes).shape[0]) > max_n:
        return None
    dev = resolve_device(device)
    a = closure_inputs(g, subsets, rw_type, packed=packed)
    n, n_pad, iters, n_sub = a["n"], a["n_pad"], a["iters"], len(subsets)
    ins = _upload(a["args"], dev)
    _sync(dev)
    t0 = time.monotonic()
    fn = packed_closure if packed else closure

    def run():
        out = fn(*ins, n_pad=n_pad, iters=iters)
        _sync(dev)
        return out

    (labels, closed, iter_counts, iters_run), dm, dmark = _watched(
        run, [dev], edges=int(a["edges"]), n=n, n_pad=n_pad, iters=iters)
    kernel_s = time.monotonic() - t0
    iter_counts = iter_counts.cpu().numpy()
    util = _reach_util(iter_counts, iters, iters_run, n_pad)
    util["kernel_s"] = round(kernel_s, 4)
    if packed:
        # word-ops model: one squaring ANDs/ORs n_pad^2 * W words/subset
        gops = 2.0 * n_sub * iters_run * float(n_pad) ** 3 / 32 / 1e9
        util = {"kernel": "packed", **util,
                "achieved_gops": round(gops / max(kernel_s, 1e-9), 2),
                "closure_bytes": int(a["args"][0].nbytes)}
    else:
        flops = 2.0 * n_sub * iters_run * float(n_pad) ** 3
        util["achieved_tflops"] = round(flops / 1e12 / max(kernel_s, 1e-9),
                                        2)
    _hbm_close(util, dm, dmark, [dev])
    _record_closure(util, a["edges"], n)
    labels = labels.cpu().numpy()[:, :n]
    closed = closed.cpu().numpy()[:, :len(a["rw_edges"])]
    _note_outputs(labels, closed, iter_counts)
    return {"sccs": _sccs_from_labels(labels, a["nodes"], n, n_sub),
            "rw_edges": a["rw_edges"], "rw_closed": closed, "util": util}


def cycle_queries(g: DepGraph,
                  subsets: Sequence[frozenset] = SUBSETS,
                  rw_type: int = RW,
                  max_n: int = DEFAULT_MAX_N,
                  device=None) -> Optional[dict]:
    """Run the batched dense closure over `subsets` and the rw-closure
    queries on `device` (None: the card). Returns
      {"sccs": [per-subset list of >1-node components (history ids)],
       "rw_edges": [(src, dst) history ids],
       "rw_closed": (S, n_rw) bool — rw edge closed under subset s,
       "util": {...}}
    or None when the graph exceeds max_n (caller falls back to host).
    """
    return _run_closure(g, subsets, rw_type, max_n, device, packed=False)


def cycle_queries_packed(g, subsets: Sequence[frozenset] = SUBSETS,
                         rw_type: int = RW, max_n: int = PACKED_MAX_N,
                         device=None) -> Optional[dict]:
    """cycle_queries on the uint32 bitset kernel: same result envelope,
    16x less closure memory, capacity to PACKED_MAX_N. The packed
    adjacency (plus identity) is assembled on the host with one
    bitwise_or scatter per subset — E word-ops, negligible."""
    return _run_closure(g, subsets, rw_type, max_n, device, packed=True)


def cycle_queries_sharded(g, subsets: Sequence[frozenset] = SUBSETS,
                          rw_type: int = RW, max_n: int = SHARDED_MAX_N,
                          n_shards: Optional[int] = None, devices=None,
                          device=None) -> Optional[dict]:
    """cycle_queries_packed with the word columns split over a device
    list (`sharded_closure`): same host-assembled packed seed, same
    result envelope; each shard receives only its column block. The
    devices are `devices` (a list that may repeat a device), else
    `[device]`, else every card; `n_shards` defaults to
    `parallel.mesh.word_shard_count` over them, and shard k runs on the
    k-th. Returns None over capacity, or when fewer than 2 shards come
    out and `n_shards` was not named (the caller falls back to packed
    or the host); `n_shards=1` runs the path on one device."""
    from ..parallel.mesh import word_shard_count

    if int(np.asarray(g.nodes).shape[0]) > max_n:
        return None
    devs = resolve_devices(devices, device)
    a = closure_inputs(g, subsets, rw_type, packed=True)
    n, n_pad, iters, n_sub = a["n"], a["n_pad"], a["iters"], len(subsets)
    Wn = n_pad // 32
    forced = n_shards is not None
    if n_shards is None:
        n_shards = word_shard_count(Wn, len(devs))
    if n_shards < 1 or Wn % n_shards or (n_shards < 2 and not forced):
        return None
    if n_shards > len(devs):
        raise ValueError(f"{n_shards} shards over {len(devs)} devices")
    r0, q_src, q_dst = a["args"]
    from ..analysis import guards

    blocks = [b.to(dev) for b, dev in
              zip(shard_blocks(torch.from_numpy(r0), n_shards), devs)]
    qs, qd = _tensor(q_src, devs[0]), _tensor(q_dst, devs[0])
    guards.note_transfer("h2d", r0.nbytes + q_src.nbytes + q_dst.nbytes,
                         what="elle-closure-inputs")
    cards = list(dict.fromkeys(devs[:n_shards]))
    for dev in cards:
        _sync(dev)
    t0 = time.monotonic()

    def run():
        out = sharded_closure(blocks, qs, qd, n_pad=n_pad, iters=iters)
        for dev in cards:
            _sync(dev)
        return out

    (labels, closed, iter_counts, iters_run), dm, dmark = _watched(
        run, cards, edges=int(a["edges"]), n=n, n_pad=n_pad, iters=iters,
        kernel="sharded")
    kernel_s = time.monotonic() - t0
    util = _reach_util(iter_counts.numpy(), iters, iters_run, n_pad)
    gops = 2.0 * n_sub * iters_run * float(n_pad) ** 3 / 32 / 1e9
    util = {"kernel": "sharded", **util, "kernel_s": round(kernel_s, 4),
            "n_shards": int(n_shards), "shard_words": Wn // n_shards,
            "devices": device_labels(devs[:n_shards]),
            "gather_bytes": int(r0.nbytes),
            "per_shard_bytes": int(r0.nbytes + 2 * r0.nbytes // n_shards),
            "achieved_gops": round(gops / max(kernel_s, 1e-9), 2),
            "closure_bytes": int(r0.nbytes)}
    _hbm_close(util, dm, dmark, cards)
    _record_closure(util, a["edges"], n)
    labels = labels.cpu().numpy()[:, :n]
    closed = closed.cpu().numpy()[:, :len(a["rw_edges"])]
    _note_outputs(labels, closed, iter_counts.numpy())
    return {"sccs": _sccs_from_labels(labels, a["nodes"], n, n_sub),
            "rw_edges": a["rw_edges"], "rw_closed": closed, "util": util}


def _neighbor_pads(n_pad, e_from, e_to, w):
    """(neigh, mask) padded adjacency-list arrays: slot d of row j =
    d-th edge endpoint, mask carries the per-subset membership."""
    n_sub = w.shape[1]
    counts = np.bincount(e_to, minlength=n_pad)
    deg = int(counts.max()) if len(e_to) else 0
    d_pad = _bucket(max(deg, 4))
    if d_pad > TRIM_MAX_DEGREE:
        return None, None, d_pad
    order = np.argsort(e_to, kind="stable")
    to_s, from_s, w_s = e_to[order], e_from[order], w[order]
    starts = np.zeros(n_pad + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    slot = np.arange(len(to_s)) - starts[to_s]
    neigh = np.zeros((n_pad, d_pad), np.int32)
    mask = np.zeros((n_pad, d_pad, n_sub), bool)
    neigh[to_s, slot] = from_s
    mask[to_s, slot, :] = w_s
    return neigh, mask, d_pad


def trim_shapes(n: int, d_in: int, d_out: int, p: int, use_rt: bool,
                use_proc: bool) -> tuple:
    """The shape bucket a trim run of these sizes lands in."""
    return (_round_up(_bucket(max(n, 2)), 128),
            _bucket(max(d_in, 4)), _bucket(max(d_out, 4)),
            max(8, _bucket(p + 1)), bool(use_rt), bool(use_proc))


def _cycle_from_core(dep: DepGraph, sub: frozenset) -> Optional[list]:
    """Host explanation once the device core is nonempty: the full
    oracle over explicit edges (the core guarantees a cycle exists, so
    this never runs on the valid-history hot path)."""
    return dep.find_cycle(types=set(sub))


def shape_bucket_for(g) -> dict:
    """The shape buckets a cycle search over `g` lands in, for every
    kernel the router might pick (mirrors the derivation in
    trim_cycle_search / cycle_queries / cycle_queries_packed)."""
    nodes = np.asarray(g.nodes)
    n = int(nodes.shape[0])
    edges = np.asarray(g.edges)
    typ = edges[:, 2] if len(edges) else np.zeros(0, np.int32)
    analytic = bool(getattr(g, "analytic", False))
    sm = np.isin(typ, [WW, WR, RW]) if analytic \
        else np.ones(len(typ), bool)
    n_pad = _n_pad_for(n)
    e_to = edges[sm, 1] if len(edges) else np.zeros(0, np.int64)
    e_from = edges[sm, 0] if len(edges) else np.zeros(0, np.int64)
    d_in = int(np.bincount(
        np.searchsorted(nodes, e_to)).max()) if len(e_to) else 0
    d_out = int(np.bincount(
        np.searchsorted(nodes, e_from)).max()) if len(e_from) else 0
    use_rt = use_proc = False
    n_procs = 0
    if analytic:
        use_rt = bool((np.asarray(g.comp_evt) < 2 ** 60).any())
        proc = np.asarray(g.proc)
        use_proc = bool((proc >= 0).any())
        n_procs = int(proc.max()) + 1 if use_proc else 0
    n_rw = int(np.sum(typ == RW)) if len(typ) else 0
    trim_b = trim_shapes(n, _bucket(max(d_in, 4)), _bucket(max(d_out, 4)),
                         n_procs, use_rt, use_proc)
    return {"n": n,
            "trim": trim_b,
            "dense": {"n_pad": n_pad,
                      "e_pad": _bucket(max(len(edges), 1)),
                      "q_pad": _bucket(max(n_rw, 1)),
                      "iters": max(1, math.ceil(math.log2(n_pad)))}}


def trim_inputs(g) -> Optional[dict]:
    """The trim kernel's inputs for `g` (see trim_cycle_search): the
    numpy arrays (in_neigh, in_mask, out_neigh, out_mask, inv, comp,
    proc, ppos, live0) and the bucket (n_pad, d_in, d_out, p_pad,
    use_rt, use_proc); None when a degree passes TRIM_MAX_DEGREE."""
    nodes = np.asarray(g.nodes)
    n = int(nodes.shape[0])
    edges = np.asarray(g.edges)
    analytic = bool(getattr(g, "analytic", False))
    id_of = {int(v): i for i, v in enumerate(nodes)}
    src = np.array([id_of[int(s)] for s in edges[:, 0]], np.int32)
    dst = np.array([id_of[int(d)] for d in edges[:, 1]], np.int32)
    typ = edges[:, 2]

    # builder mode scatters only ww/wr/rw; realtime/process are jumps
    sm = np.isin(typ, [WW, WR, RW]) if analytic \
        else np.ones(len(typ), bool)
    e_src, e_dst, e_typ = src[sm], dst[sm], typ[sm]
    n_sub = len(SUBSETS)
    w = np.zeros((len(e_src), n_sub), bool)
    for si, sub in enumerate(SUBSETS):
        w[:, si] = np.isin(e_typ, list(sub))

    use_rt = use_proc = False
    if analytic:
        inv_e = np.asarray(g.inv_evt)
        comp_e = np.asarray(g.comp_evt)
        proc = np.asarray(g.proc)
        ppos = np.asarray(g.proc_pos)
        use_rt = bool((comp_e < 2 ** 60).any())
        use_proc = bool((proc >= 0).any())
        n_procs = int(proc.max()) + 1 if use_proc else 0
    else:
        inv_e = comp_e = proc = ppos = None
        n_procs = 0

    n_pad = _round_up(_bucket(max(n, 2)), 128)
    in_neigh, in_mask, d_in_raw = _neighbor_pads(n_pad, e_src, e_dst, w)
    out_neigh, out_mask, d_out_raw = _neighbor_pads(n_pad, e_dst,
                                                    e_src, w)
    if in_neigh is None or out_neigh is None:
        return None
    n_pad, d_in, d_out, p_pad, _, _ = trim_shapes(
        n, d_in_raw, d_out_raw, n_procs, use_rt, use_proc)

    if use_rt or use_proc:
        inv_p = _pad(np.clip(inv_e, -_BIGI, _BIGI), n_pad, -_BIGI)
        comp_p = _pad(np.clip(comp_e, -_BIGI, _BIGI), n_pad, _BIGI)
        proc_p = _pad(np.where(proc < 0, p_pad - 1, proc), n_pad, p_pad - 1)
        ppos_p = _pad(ppos, n_pad, -1)
    else:
        inv_p = np.full(n_pad, -_BIGI, np.int32)
        comp_p = np.full(n_pad, _BIGI, np.int32)
        proc_p = np.full(n_pad, p_pad - 1, np.int32)
        ppos_p = np.full(n_pad, -1, np.int32)
    live0 = np.zeros((n_pad, n_sub), bool)
    live0[:n] = True
    return {"arrays": (in_neigh, in_mask, out_neigh, out_mask, inv_p,
                       comp_p, proc_p, ppos_p, live0),
            "n_pad": n_pad, "d_in": d_in, "d_out": d_out, "p_pad": p_pad,
            "use_rt": use_rt, "use_proc": use_proc,
            "edges": int(len(e_src))}


def trim_cycle_search(g, max_n: int = PACKED_MAX_N,
                      device=None) -> Optional[dict]:
    """The full query battery on the trim kernel. `g` is a
    GraphTensors (builder mode: analytic interval jumps, only
    ww/wr/rw columns scatter) or a DepGraph (generic mode: every edge
    scatters). Returns the standard_cycle_search dict, or None over
    capacity.

    G0/G1c fire iff their subset core is nonempty. G-single/G2 anchor
    on rw edges; a cycle's nodes all survive trimming, so only rw
    edges with BOTH endpoints in the S2 core are candidates — zero
    for valid histories — and each candidate is settled by one host
    BFS over the allowed path types."""
    nodes = np.asarray(g.nodes)
    n = int(nodes.shape[0])
    if n > max_n:
        return None
    edges = np.asarray(g.edges)
    s0, s1, s2 = SUBSETS
    battery = {"G0": None, "G1c": None, "G-single": None, "G2": None}
    if n == 0 or not len(edges):
        return {**battery, "engine": "device",
                "util": {"kernel": "trim", "skipped": "empty-graph",
                         "kernel_s": 0.0}}
    dev = resolve_device(device)
    t = trim_inputs(g)
    if t is None:
        return None  # degree past the gather bucket: dense kernels
    ins = _upload(t["arrays"], dev)
    n_pad, d_in, d_out, use_rt, use_proc = (
        t["n_pad"], t["d_in"], t["d_out"], t["use_rt"], t["use_proc"])
    _sync(dev)
    t0 = time.monotonic()

    def run():
        out = trim(*ins, p_pad=t["p_pad"], use_rt=use_rt,
                   use_proc=use_proc)
        _sync(dev)
        return out

    (live, counts, bodies), dm, dmark = _watched(
        run, [dev], edges=int(t["edges"]), n=n, n_pad=n_pad, kernel="trim")
    kernel_s = time.monotonic() - t0
    bodies = max(1, int(bodies))
    iters_run = 2 * bodies  # two peel rounds per loop body
    counts = counts.cpu().numpy()[:min(bodies, TRIM_COUNTS_ROWS)]
    live = live.cpu().numpy()[:n]
    _note_outputs(live, counts)
    core_sizes = [int(live[:, si].sum()) for si in range(len(SUBSETS))]
    util = {"kernel": "trim", "n_pad": n_pad,
            "d_in": d_in, "d_out": d_out,
            "edges": t["edges"],
            "iters_run": iters_run,
            "kernel_s": round(kernel_s, 4),
            "iter_reach": [[int(v) for v in row] for row in counts],
            "converged_at": iters_run,
            "core_sizes": core_sizes,
            "reach_density": round(max(core_sizes) / max(n, 1), 6),
            "jumps": {"rt": use_rt, "proc": use_proc}}
    _hbm_close(util, dm, dmark, [dev])
    _record_closure(util, t["edges"], n)

    out: dict = {**battery, "engine": "device", "util": util}
    if not any(core_sizes):
        return out  # valid: the device core IS the verdict
    dep = g.to_depgraph() if hasattr(g, "to_depgraph") else g
    if core_sizes[0]:
        out["G0"] = _cycle_from_core(dep, s0)
    if core_sizes[1]:
        out["G1c"] = _cycle_from_core(dep, s1)
    if core_sizes[2]:
        # rw anchors with both endpoints in the S2 core
        core2 = {int(nodes[i]) for i in np.flatnonzero(live[:, 2])}
        adj1 = dep.adjacency(set(s1))
        adj2 = dep.adjacency(set(s2))
        for ei in np.flatnonzero(edges[:, 2] == RW):
            u, v = int(edges[ei, 0]), int(edges[ei, 1])
            if u not in core2 or v not in core2:
                continue
            if out["G-single"] is None:
                path = _bfs_path(adj1, v, u)
                if path is not None:
                    out["G-single"] = [u] + path
            if out["G2"] is None:
                path = _bfs_path(adj2, v, u)
                if path is not None:
                    out["G2"] = [u] + path
            if out["G-single"] is not None \
                    and out["G2"] is not None:
                break
    return out


def _squaring_select(n: int, device, devices=None) -> tuple:
    """bf16 vs packed vs sharded for one shape bucket, from an analytic
    byte model (the reference asks `Lowered.cost_analysis`). Past the
    bf16 cap, packed is the only one-card option; below it, packed wins
    when the bf16 closure's live working set (S planes of n_pad^2 bf16,
    the second buffer and the product's staging: 3 S n_pad^2 2 B)
    passes a quarter of the card's memory. On an 80 GB card that check
    never picks packed below DEFAULT_MAX_N (the largest bf16 bucket,
    n_pad 8320, holds 1.25 GB against a 20 GB budget), so n decides
    alone there. Past PACKED_MAX_N the word-column shards are the only
    dense option: sharded is picked when the devices (`devices`, else
    every card) yield >= 2 word shards and each card holds its shards'
    working sets (the gather buffer and two column blocks a shard:
    bitset x (1 + 2 / n_shards), summed over the shards a card holds);
    otherwise packed is returned so the caller's capacity check, and
    the host fallback behind it, fires. `device` is a CUDA device: the
    CPU always runs the trim."""
    if n > PACKED_MAX_N:
        from ..parallel.mesh import word_shard_count

        devs = resolve_devices(devices, device)
        n_pad_s = _n_pad_for(n)
        ns = word_shard_count(n_pad_s // 32, len(devs))
        bitset = len(SUBSETS) * float(n_pad_s) ** 2 / 8.0
        per_shard = bitset * (1.0 + 2.0 / ns)
        on_card = {}
        for d in devs[:ns]:
            on_card[d] = on_card.get(d, 0.0) + per_shard
        fits = all(b <= torch.cuda.get_device_properties(d).total_memory
                   for d, b in on_card.items())
        sel = {"n_shards": ns, "per_shard_bytes": int(per_shard),
               "gather_bytes_per_iter": int(bitset),
               "bytes_per_card": {str(d): int(b) for d, b in on_card.items()}}
        if n <= SHARDED_MAX_N and ns >= 2 and fits:
            sel["why"] = (f"n {n} > packed cap {PACKED_MAX_N}; {ns}-shard "
                          "columns fit the cards")
            return "sharded", sel
        sel["why"] = (f"n {n} over packed cap and the sharded layout does "
                      f"not fit ({ns} shards, {per_shard:.2e} per shard)")
        return "packed", sel
    if n > DEFAULT_MAX_N:
        return "packed", {"why": f"n {n} > bf16 cap {DEFAULT_MAX_N}"}
    n_pad = _n_pad_for(n)
    live = 3 * len(SUBSETS) * float(n_pad) ** 2 * 2
    budget = 0.25 * torch.cuda.get_device_properties(device).total_memory
    sel = {"bytes_bf16": int(live), "budget_bytes": budget}
    if live > budget:
        sel["why"] = f"bf16 live bytes {live:.2e} over {budget:.2e} budget"
        return "packed", sel
    sel["why"] = "bf16 working set fits; tensor-core squaring wins"
    return "bf16", sel


def device_cycle_search(g, max_n: int = PACKED_MAX_N,
                        kernel: Optional[str] = None,
                        device=None, devices=None) -> Optional[dict]:
    """The query battery on the device kernel family. Kernel choice
    per shape: `trim` on a CPU device (a dense squaring there costs
    seconds per subset; the trim fixpoint milliseconds), while the card
    keeps the dense closures with bf16 vs packed vs sharded decided by
    `_squaring_select` (past PACKED_MAX_N the word-column shards over
    `devices` are the only dense option; a sharded pick with fewer than
    2 shards falls back to packed when n still fits one card). `device`
    defaults to the first of `devices`. Returns None over capacity."""
    if device is None and devices is not None:
        device = devices[0]
    dev = resolve_device(device)
    n = int(np.asarray(g.nodes).shape[0])
    accel = dev.type == "cuda"
    if kernel is None:
        if accel:
            kernel, sel = _squaring_select(n, dev, devices)
        else:
            kernel = "trim"
            sel = {"why": "cpu device: dense squaring is "
                          "compute-prohibitive; trim kernel"}
    else:
        sel = {"why": f"forced {kernel}"}

    if kernel == "trim":
        res = trim_cycle_search(g, max_n=min(max_n, PACKED_MAX_N),
                                device=dev)
        if res is not None:
            res["util"]["select"] = sel
            return res
        if not accel:
            # never fall through to a dense squaring on the CPU: at
            # trim-refusing sizes the host oracle is the right engine
            return None
        if n > PACKED_MAX_N:
            kernel, sel = "sharded", {"why": "over trim capacity; "
                                             "sharded columns"}
        else:
            kernel, sel = "packed", {"why": "over trim capacity"}

    s0, s1, s2 = SUBSETS
    # the dense kernels read only .nodes/.edges, which GraphTensors
    # provides directly — the labeled DepGraph materializes lazily
    # below, and only when something actually needs explaining
    if kernel == "sharded":
        qres = cycle_queries_sharded(g, max_n=max(max_n, SHARDED_MAX_N),
                                     devices=devices, device=dev)
        if qres is None and n <= PACKED_MAX_N:
            # fewer than 2 word shards: one card's packed kernel still
            # covers this n
            kernel = "packed"
            sel = dict(sel, fallback="sharded unavailable; packed covers n")
            qres = cycle_queries_packed(g, max_n=min(max_n, PACKED_MAX_N),
                                        device=dev)
    elif kernel == "bf16":
        qres = cycle_queries(g, max_n=min(max_n, DEFAULT_MAX_N), device=dev)
    else:
        qres = cycle_queries_packed(g, max_n=min(max_n, PACKED_MAX_N),
                                    device=dev)
    if qres is None:
        return None
    out = {"engine": "device", "util": dict(qres["util"])}
    out["util"].setdefault("kernel", kernel)
    out["util"]["select"] = sel
    hits = (any(qres["sccs"][si] for si in range(len(SUBSETS)))
            or bool(np.asarray(qres["rw_closed"]).any()))
    dep = (g.to_depgraph() if hits and hasattr(g, "to_depgraph")
           else g)
    for name, si, sub in (("G0", 0, s0), ("G1c", 1, s1)):
        cyc = None
        if hits:
            for comp in qres["sccs"][si]:
                cyc = dep._cycle_in(set(comp), set(sub))
                if cyc:
                    break
        out[name] = cyc
    out["G-single"] = _first_closed(dep, qres, 1, set(s1)) \
        if hits else None
    out["G2"] = _first_closed(dep, qres, 2, set(s2)) if hits else None
    return out


def standard_cycle_search(g, backend: str = "host",
                          max_n: int = DEFAULT_MAX_N,
                          device=None, devices=None) -> dict:
    """The four-query battery both elle checkers run, on any engine.
    `g` is a DepGraph or an elle/build.py GraphTensors. Returns
    {"G0": cycle|None, "G1c": ..., "G-single": ..., "G2": ...} where
    each cycle is a node list [a, ..., a]; device verdicts are
    re-derived into concrete cycles host-side, restricted to the
    flagged component/edge ("device decides, host explains").

    backend:
      "host"    Tarjan + per-edge BFS oracle (and the explainer).
      "cuda"    the dense bf16 closure over the explicit DepGraph,
                engine "cuda" (the reference's "tpu" backend).
      "packed"  the uint32 bitset closure (capacity PACKED_MAX_N).
      "sharded" the bitset closure with its word columns split over
                `devices` (capacity SHARDED_MAX_N; falls back to packed
                when the devices yield < 2 shards and n fits one card).
      "trim"    the peel-to-core trim kernel.
      "device"  kernel picked per shape (device_cycle_search).
      "auto"    ops/route.elle_cycle_route decides host vs device vs
                sharded from (n, e, rw) shape stats and the word shards
                the devices yield; the decision is recorded as
                `route_reason`.

    `device` is where the one-device kernels run (None: the first of
    `devices`, else the card, raising without one; "cpu": their plain
    versions); `devices` is the sharded closure's device list (None:
    every card; a list may repeat a device). "host" needs neither. The
    "engine" key records what actually ran ("cuda", "device", "trim",
    "packed", "sharded", "host", or "host-fallback" when a device
    request exceeded capacity); device results carry util.kernel."""
    s0, s1, s2 = SUBSETS
    engine = backend
    route_reason = None
    if device is None and devices is not None:
        device = devices[0]
    if backend == "auto":
        from ..ops.route import elle_cycle_route
        from ..parallel.mesh import word_shard_count
        dev = resolve_device(device)
        edges = np.asarray(g.edges)
        rw = int(np.sum(edges[:, 2] == RW)) if len(edges) else 0
        n_route = int(np.asarray(g.nodes).shape[0])
        accel = dev.type == "cuda"
        ns_route = (word_shard_count(
            _n_pad_for(n_route) // 32,
            len(devices) if devices is not None else None)
            if accel else 0)
        backend, route_reason = elle_cycle_route(
            n=n_route, e=int(len(edges)), rw_edges=rw, accel=accel,
            device_ok=True, packed_cap=PACKED_MAX_N,
            sharded_cap=SHARDED_MAX_N, n_shards=ns_route)
        engine = backend
    if backend == "device":
        res = device_cycle_search(g, max_n=max(max_n, SHARDED_MAX_N),
                                  device=device, devices=devices)
        if res is None:
            backend = engine = "host-fallback"  # over capacity
        else:
            if route_reason:
                res["route_reason"] = route_reason
            return res
    if backend in ("trim", "packed", "sharded"):
        res = device_cycle_search(g, max_n=max(max_n, SHARDED_MAX_N),
                                  kernel=backend, device=device,
                                  devices=devices)
        if res is None:
            backend = engine = "host-fallback"
        else:
            # a forced trim request can still fall through to packed
            # (degree past the gather bucket on the card), and a sharded
            # one to packed (fewer than 2 shards): only claim the forced
            # engine when it actually ran
            if res["util"].get("kernel", backend) == backend:
                res["engine"] = backend
            if route_reason:
                res["route_reason"] = route_reason
            return res
    if backend == "cuda":
        dep = g.to_depgraph() if hasattr(g, "to_depgraph") else g
        res = cycle_queries(dep, max_n=max_n, device=device)
        if res is None:
            backend = engine = "host-fallback"  # over capacity
        else:
            out = {"engine": "cuda", "util": res["util"]}
            for name, si, sub in (("G0", 0, s0), ("G1c", 1, s1)):
                cyc = None
                for comp in res["sccs"][si]:
                    cyc = dep._cycle_in(set(comp), set(sub))
                    if cyc:
                        break
                out[name] = cyc
            # G-single: rw edge closed by a NON-rw path (subset 1);
            # G2: closed by any path (subset 2)
            out["G-single"] = _first_closed(dep, res, 1, set(s1))
            out["G2"] = _first_closed(dep, res, 2, set(s2))
            return out
    if backend not in ("host", "host-fallback"):
        raise ValueError(f"unknown backend {backend!r}")
    dep = g.to_depgraph() if hasattr(g, "to_depgraph") else g
    out = {
        "engine": engine,
        "G0": dep.find_cycle(types=set(s0)),
        "G1c": dep.find_cycle(types=set(s1)),
        "G-single": dep.find_cycle_with(RW, set(s1),
                                        exactly_one=True),
        "G2": dep.find_cycle_with(RW, set(s1), exactly_one=False),
    }
    if route_reason:
        out["route_reason"] = route_reason
    return out


def _first_closed(g: DepGraph, res: dict, subset_idx: int,
                  path_types: set) -> Optional[list]:
    """Host re-derivation: for the first device-flagged rw edge, the
    concrete closing path (BFS over path_types, one edge's worth of
    work)."""
    closed = res["rw_closed"][subset_idx]
    adj = g.adjacency(path_types - {RW}) if subset_idx == 1 \
        else g.adjacency(path_types)
    for ei, (s, d) in enumerate(res["rw_edges"]):
        if not closed[ei]:
            continue
        path = _bfs_path(adj, d, s)
        if path is not None:
            return [s] + path
    return None
