"""Shape-aware engine routing for Elle's cycle search.

A copy of `elle_cycle_route` from the JAX package's
`jepsen_tpu/ops/route.py`; the WGL router of that module is not ported
yet. `n_shards` is the word-column shard count the caller's devices
yield (`parallel.mesh.word_shard_count`; 0 on the CPU), and `sharded_cap`
the sharded closure's capacity. The device is always usable: a missing
card raises when the device is resolved, before any route is taken.
"""

from __future__ import annotations


def elle_cycle_route(*, n: int, e: int, rw_edges: int,
                     accel: bool, device_ok: bool,
                     packed_cap: int = 32768,
                     sharded_cap: int = 131072,
                     n_shards: int = 0,
                     cpu_cap: int = 16384,
                     min_n: int = 384,
                     min_host_work: int = 2_000_000) -> tuple:
    """Decide host vs device for the cycle-query battery from static
    graph stats, and say why (`route_reason` on results).

    The host engine's hot spot is the per-rw-edge BFS in
    DepGraph.find_cycle_with — O(rw_edges x E) when the history is
    valid (every BFS exhausts the reachable set). The device battery
    answers every query from one closure, so routing is a host-work
    model against a capacity check:

      * no usable device                -> host
      * n > packed closure capacity     -> "sharded" when the cards
                                           yield >= 2 word-column
                                           shards and n fits the
                                           sharded cap; host otherwise
      * small graph AND small BFS bill  -> host (a kernel launch costs
                                           more than it saves)
      * otherwise                       -> device; elle/tpu.py picks
                                           the kernel per shape
                                           (bf16 / packed / trim).

    Returns (backend, reason) with backend in {"host", "device",
    "sharded"}."""
    host_work = rw_edges * max(e, 1)
    if not device_ok:
        return ("host", "no usable device; host Tarjan/BFS")
    if n > packed_cap:
        if accel and n <= sharded_cap and n_shards >= 2:
            return ("sharded",
                    f"n {n} over packed closure capacity "
                    f"{packed_cap}; {n_shards}-shard word columns "
                    f"across the cards hold it")
        return ("host", f"n {n} over packed closure capacity "
                        f"{packed_cap}"
                        + (f" and no shardable fleet "
                           f"({n_shards} shards)" if accel else "")
                        + "; host Tarjan/BFS")
    if not accel and n > cpu_cap:
        # past this the trim's peel rounds (bounded by n_pad) stop
        # paying for themselves on the CPU, and the dense squarings
        # were never an option there
        return ("host", f"n {n} over cpu device cap {cpu_cap}; "
                        "host Tarjan/BFS")
    if n < min_n and host_work < min_host_work:
        return ("host", f"small graph (n {n}, rw*E {host_work}): "
                        "host BFS beats a kernel launch")
    plat = "cuda" if accel else "cpu"
    return ("device", f"n {n}, E {e}, rw {rw_edges} "
                      f"(host BFS model ~{host_work} node-visits) "
                      f"-> device closure battery on {plat}")
