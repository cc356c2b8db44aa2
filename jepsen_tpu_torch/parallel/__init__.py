"""Per-key fan-out of the WGL search on one card.

The reference copes with expensive checks by splitting a test into
independent keys and checking each key's subhistory on a CPU thread pool
(`jepsen/src/jepsen/independent.clj:266-317`, bounded-pmap). Here the
keys' histories are encoded into one shared shape bucket and searched
either all at once, one CUDA block per key (`strategy="vmap"`, the
`wgl32_chunk_batched` / `wgln_chunk_batched` kernels), or one key after
another (`strategy="stream"`, `ops.wgl.check` per key). Every per-key
result carries a `shard` block, and `independent` derives the
`util.fleet` aggregates from them (`fleet.summarize`).

The port of `jepsen_tpu/parallel/` for one device; its multi-device
scheduler (`check_mesh`) and worker pool are not ported yet.
"""

from .batched import (STRATEGIES, BatchEncoded, check_batched,
                      check_streamed, encode_batch, shared_shape_bucket)

__all__ = ["STRATEGIES", "BatchEncoded", "check_batched", "check_streamed",
           "encode_batch", "shared_shape_bucket"]
