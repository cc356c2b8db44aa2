"""Ahead-of-time warm-up of the port's kernels: the warm plane.

The port of the warm half of `jepsen_tpu/ops/aot.py`. There is no XLA
executable to compile ahead of time here: what a first check pays is
the `nvcc` build of a kernel source, the `ctypes` load of its library,
each entry point's first bind (all three counted by
`analysis/guards.CompileGuard`), the lazy load of each kernel form onto
the card at its first launch, and the caching allocator's first
segments; on the CPU, the host compiler's build of the host kernels
(`csrc/wgl_host.cpp`, `csrc/elle_trim_host.cpp`: the Elle warm's trim),
their loads and binds (a "host_build", a "host_load" and a "bind" each
to the guard). Every function below pays them ahead of traffic by launching,
once, each kernel a check over one shape bucket may launch, through the
same wrappers and the same launch-form pick as that check. A build or
launch failure raises: a warm never hides a missing kernel.

After a warm, a check over the same bucket counts zero compiles under a
`CompileGuard(max_compiles=0)`.

Not ported (they lower for libtpu, and `occupancy.py` counts the port's
costs analytically): `aot_compile`, `tpu_topology`,
`_single_chip_sharding`, `wgl32_case`, `wgln_case`, `elle_case` and
`evidence`.
"""

from __future__ import annotations

import time
from typing import Optional


def precompile_wgl_ladder(*, n_pad: int, ic_pad: int, S: int, O: int,
                          H: int = 1 << 23, B: int = 1 << 18,
                          chunk: int = 1024, probes: int = 4,
                          W: int = 8, L: int = 0,
                          ladder: Optional[tuple] = None,
                          device=None) -> dict:
    """Launch every adaptive-ladder bucket's chunk kernel for one shape
    bucket on `device` (None: the card), ahead of traffic
    (`adapt.precompile_ladder`): after this returns, a search over this
    shape builds, loads and binds nothing, whichever buckets the
    occupancy policy visits. The reference's `accel`, `depth` and `pack`
    have no counterpart (one kernel layout). Returns {K: seconds}."""
    from .adapt import LADDER32, precompile_ladder
    return precompile_ladder(
        n_pad=n_pad, ic_pad=ic_pad, S=S, O=O, H=H, B=B, chunk=chunk,
        probes=probes, W=W, L=L, ladder=ladder or LADDER32, device=device)


def service_ladder(shape_bucket: dict, *, device=None) -> dict:
    """The `precompile_wgl_ladder` arguments of a `service.bucket_for`
    canonical shape bucket: the plan `wgl.check` runs for any member of
    the bucket on `device` (through the shared `wgl.derive_plan`, so
    that the warmed launches are the scheduled ones)."""
    from ..util import resolve_device
    from . import wgl as wgl_mod

    dev = resolve_device(device)
    b = shape_bucket
    w_eff = int(b["w_eff"])
    wide = w_eff > 32
    # any window_raw on the right side of the 32 branch point yields
    # this bucket's plan: derive_plan maxes W_eff with the bucket's
    window_raw = w_eff if wide else min(32, w_eff)
    plan = wgl_mod.derive_plan(
        window_raw=window_raw, ic_pad=int(b["ic_pad"]),
        n=int(b.get("n_cap") or b["n_pad"]), n_info=int(b["ic_pad"]),
        accel=dev.type == "cuda", shape_bucket=b)
    return dict(n_pad=int(b["n_pad"]), ic_pad=plan["ic_eff"], S=int(b["S"]),
                O=int(b["O"]), H=plan["H"], B=plan["B"], chunk=plan["chunk"],
                probes=plan["probes"], W=plan["W_eff"], L=plan["L"],
                ladder=tuple(plan["ladder"] or plan["buckets"]), device=dev)


def precompile_service_bucket(shape_bucket: dict, *, device=None) -> dict:
    """`precompile_wgl_ladder` driven by a `service.bucket_for` canonical
    shape bucket (`service_ladder`): every ladder bucket of the plan
    `wgl.check` runs for any member of the bucket, launched on `device`.
    Returns {K: seconds}."""
    return precompile_wgl_ladder(**service_ladder(shape_bucket,
                                                  device=device))


def precompile_mesh_plan(shape_bucket: dict, devices=None, *,
                         lanes_per_device: Optional[int] = None,
                         n_keys: Optional[int] = None,
                         chunk: int = 1024, model_name: str = "any",
                         save: bool = True) -> dict:
    """`precompile_wgl_ladder`'s sibling for the mesh fan-out
    (`parallel/mesh.warm_plan`): launch every kernel the lane scheduler
    may launch for one shared shape bucket over `devices` (the run's
    device list, which may repeat a card; None: every card), register
    the plan in the port's `fs_cache`, and, for a named list, stock the
    carry pool with the run's starting carries. Pass `n_keys` (or
    `lanes_per_device`) matching the traffic (`mesh.lanes_for` is the
    scheduler's own derivation). Returns {K: seconds}."""
    from ..parallel import mesh as mesh_mod

    return mesh_mod.warm_plan(
        shape_bucket, devices=devices, lanes_per_device=lanes_per_device,
        n_keys=n_keys, chunk=chunk, model_name=model_name, save=save)


def precompile_service_plan(shape_bucket: dict, *, bucket_key,
                            model_name: Optional[str] = None,
                            mesh_layout: Optional[dict] = None,
                            save: bool = True, device=None,
                            devices=None) -> dict:
    """One warm for a service bucket: the serial ladder
    (`precompile_service_bucket` on `device`) and, when a mesh layout is
    given, the lane-group plan (`precompile_mesh_plan`) over the
    caller's mesh `devices` (a list of 2 or more that may repeat a
    card: a named list also stocks the carry pool) for the same
    canonical bucket, registered as one `fs_cache` entry under
    ("service-plan", model, key) (best effort). `mesh_layout` is
    {"n_devices": int, "lanes_per_device": int, "chunk": int}; a layout
    without a device list of 2 or more raises rather than skip the
    mesh warm. Returns {"serial": {K: s}, "mesh": {K: s} | None}."""
    from ..util import resolve_devices

    layout = None
    if mesh_layout:
        if devices is None:
            raise ValueError("a mesh layout needs the mesh's devices=")
        devs = resolve_devices(devices)
        if len(devs) < 2:
            raise ValueError(f"a mesh of {len(devs)} device(s): a mesh "
                             f"layout needs 2 or more")
    out: dict = {"serial": precompile_service_bucket(shape_bucket,
                                                     device=device),
                 "mesh": None}
    if mesh_layout:
        chunk = int(mesh_layout.get("chunk") or 1024)
        s_d = int(mesh_layout["lanes_per_device"])
        out["mesh"] = precompile_mesh_plan(
            shape_bucket, devs, lanes_per_device=s_d, chunk=chunk,
            model_name=str(model_name or "any"), save=False)
        layout = {"n_devices": len(devs), "lanes_per_device": s_d,
                  "chunk": chunk, "axes": ["keys"]}
    if save:
        try:
            from .. import fs_cache
            keystr = "-".join(str(k) for k in tuple(bucket_key))
            fs_cache.save_data(
                ("service-plan", str(model_name), keystr),
                {"bucket": shape_bucket, "key": list(bucket_key),
                 "model": model_name, "mesh": layout,
                 "t": round(time.time(), 3)})
        except Exception:  # noqa: BLE001 — the registry is a warm-up
            pass           # accelerant, never a correctness gate
    return out


def precompile_cached_mesh_plans(devices=None) -> list:
    """Re-warm every mesh plan earlier traffic registered in the port's
    `fs_cache` (`precompile_mesh_plan(save=True)`): a fresh process walks
    the ("mesh-plan",) registry and warms each recorded (bucket, lanes)
    plan over `devices` (None: every card) before traffic arrives. A
    plan is skipped only when its recorded device count does not match
    the list or its record cannot be read; a build or launch failure
    while warming raises. Returns [{model, bucket, lanes_per_device,
    compile_s: {K: s}}] per warmed plan."""
    from .. import fs_cache
    from ..parallel import mesh as mesh_mod
    from ..util import default_devices, resolve_devices

    devs = (resolve_devices(devices) if devices is not None
            else default_devices())
    nd = len(devs)
    out = []
    for plan in fs_cache.list_data(("mesh-plan",)):
        if not isinstance(plan, dict) or "bucket" not in plan:
            continue
        if int(plan.get("n_devices") or 0) != nd:
            continue
        compile_s = mesh_mod.warm_plan(
            plan["bucket"], devices=devices, n_devices=nd,
            lanes_per_device=plan.get("lanes_per_device"),
            chunk=int(plan.get("chunk") or 1024),
            model_name=plan.get("model") or "any", save=False)
        out.append({"model": plan.get("model"), "bucket": plan["bucket"],
                    "lanes_per_device": plan.get("lanes_per_device"),
                    "compile_s": compile_s})
    return out


def precompile_elle_closure(shape_bucket: dict,
                            kernels: Optional[tuple] = None, *,
                            device=None, devices=None) -> dict:
    """`precompile_wgl_ladder`'s sibling for the Elle cycle engines:
    launch, once, every closure kernel the router may pick for one shape
    bucket (`elle/tpu.shape_bucket_for`), through the checker's own
    wrappers at the bucket's n_pad: the trim on an empty graph, and for
    bf16 / packed / sharded one squaring of a zero reach plus the label
    pass (`iters=1`). The caching allocator then holds the bucket's
    segments. `kernels` defaults to ("trim",) plus, on the card, the
    router's squaring pick (`_squaring_select`). "sharded" runs over
    `devices` (None: every card) and is skipped when they give fewer
    than 2 word shards (the router takes packed then). Returns {kernel:
    seconds}."""
    import torch

    from ..elle import tpu as elle_tpu
    from ..util import resolve_device, resolve_devices

    if device is None and devices is not None:
        device = devices[0]
    dev = resolve_device(device)
    if kernels is None:
        kernels = ("trim",)
        if dev.type == "cuda":
            pick, _sel = elle_tpu._squaring_select(
                int(shape_bucket.get("n") or 0), dev, devices)
            kernels = ("trim", pick)
    S = len(elle_tpu.SUBSETS)

    def on(shape, dtype, d=dev):
        return torch.zeros(shape, dtype=dtype, device=d)

    def sync(devs):
        for d in dict.fromkeys(devs):
            if d.type == "cuda":
                # kernellint: ok(K007) — a warm's one wait a card
                torch.cuda.synchronize(d)

    out: dict = {}
    for k in kernels:
        t0 = time.monotonic()
        used = [dev]
        if k == "trim":
            n_pad, d_in, d_out, p_pad, use_rt, use_proc = \
                shape_bucket["trim"]
            i32, b = torch.int32, torch.bool
            elle_tpu.trim(on((n_pad, d_in), i32), on((n_pad, d_in, S), b),
                          on((n_pad, d_out), i32), on((n_pad, d_out, S), b),
                          on(n_pad, i32), on(n_pad, i32), on(n_pad, i32),
                          on(n_pad, i32), on((n_pad, S), b), p_pad=p_pad,
                          use_rt=bool(use_rt), use_proc=bool(use_proc))
        elif k in ("bf16", "packed", "sharded"):
            d = (shape_bucket.get("sharded") if k == "sharded" else None) \
                or shape_bucket["dense"]
            n_pad, q_pad = int(d["n_pad"]), int(d["q_pad"])
            q = on(q_pad, torch.int32)
            if k == "bf16":
                e_pad = int(d["e_pad"])
                elle_tpu.closure(on(e_pad, torch.int32),
                                 on(e_pad, torch.int32),
                                 on((S, e_pad), torch.float32), q, q.clone(),
                                 n_pad=n_pad, iters=1)
            elif k == "packed":
                elle_tpu.packed_closure(on((S, n_pad, n_pad // 32),
                                           torch.int32), q, q.clone(),
                                        n_pad=n_pad, iters=1)
            else:
                from ..parallel.mesh import word_shard_count
                devs = resolve_devices(devices, dev)
                ns = word_shard_count(n_pad // 32, len(devs))
                if ns < 2:
                    continue
                used = devs[:ns]
                r0 = torch.zeros((S, n_pad, n_pad // 32), dtype=torch.int32)
                blocks = [b.to(x) for b, x in
                          zip(elle_tpu.shard_blocks(r0, ns), used)]
                elle_tpu.sharded_closure(blocks, q, q.clone(), n_pad=n_pad,
                                         iters=1)
        else:
            raise ValueError(f"unknown elle kernel {k!r}")
        sync(used)
        out[k] = time.monotonic() - t0
    return out
