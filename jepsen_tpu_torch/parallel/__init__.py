"""Per-key fan-out of the WGL search over one device or several.

The reference copes with expensive checks by splitting a test into
independent keys and checking each key's subhistory on a CPU thread pool
(`jepsen/src/jepsen/independent.clj:266-317`, bounded-pmap). Here the
keys' histories are encoded into one shared shape bucket and searched
all at once, one CUDA block per key (`strategy="vmap"`, the
`wgl32_chunk_batched` / `wgln_chunk_batched` kernels, the lanes split
over the devices), through the mesh lane scheduler (`mesh.check_mesh`:
a window of lane slots per device, refilled as keys are decided), or
one key after another (`strategy="stream"`, `ops.wgl.check` per key,
one worker a device). Every per-key result carries a `shard` block, and
`independent` derives the `util.fleet` aggregates from them
(`fleet.summarize`).

The port of `jepsen_tpu/parallel/`; a list of devices plays its device
mesh (`util.default_devices`, every card, when none is named).
"""

from ..util import default_devices
from .batched import (STRATEGIES, BatchEncoded, check_batched,
                      check_streamed, encode_batch, shared_shape_bucket)

__all__ = ["STRATEGIES", "BatchEncoded", "check_batched", "check_streamed",
           "default_devices", "encode_batch", "shared_shape_bucket"]
