"""Test orchestration: the master `run()` lifecycle, and the analysis
half of it.

The port of `jepsen_tpu/core.py` (core.clj): `run(test)` takes a test
map (core.clj:328-353: nodes, ssh, os, db, client, nemesis, generator,
checker, net, remote, ...), prepares it (core.clj:311-325), opens
sessions to every node in parallel (with-sessions, core.clj:275-295),
sets up the OS (core.clj:93-100) and DB (db.cycle with retries and log
snarfing, core.clj:172-181), runs the case (nemesis setup in parallel
with client open/setup per node, then the interpreter's hot loop,
core.clj:183-219) under the relative-time clock, indexes the history,
checks it (`analyze`, core.clj:221-237), persists everything through the
store (three-phase save) and logs a human verdict (`log_results`,
core.clj:239-252).

For the run it installs the reference's ambient defaults and restores
the previous ones on the way out, also when the run raises: a
`fleet.RunStatus` mirrored to `<store_root>/current-status.json`, a
`ledger.Ledger` at the store root (named runs), a
`devices.DeviceMonitor`, and a `watchdog.Watchdog` when none is enabled.
The reference's `enable_compilation_cache` call has no twin: the port's
kernels persist under `build/torch_kernels/`, keyed by the hash of their
sources (`ops/_native.py`).
"""

from __future__ import annotations

import logging
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor

from . import checker as jchecker
from . import control
from . import db as jdb
from . import nemesis as jnemesis
from . import util
from .generator import interpreter
from .history import History

log = logging.getLogger(__name__)


def prepare_test(test: dict) -> dict:
    """Ensure start_time and concurrency (core.clj:311-325)."""
    test = dict(test)
    if not test.get("start_time"):
        test["start_time"] = _time.strftime("%Y%m%dT%H%M%S")
    if not test.get("concurrency"):
        test["concurrency"] = len(test.get("nodes") or [])
    return test


class _Sessions:
    """Open sessions to all nodes in parallel; close them afterwards
    (with-sessions + with-resources, core.clj:70-91, 275-295)."""

    def __init__(self, test: dict):
        self.test = test
        self.sessions: dict = {}

    def __enter__(self) -> dict:
        nodes = self.test.get("nodes") or []
        try:
            opened = util.real_pmap(control.bound_fn(control.session),
                                    nodes)
        except Exception:
            self.close()
            raise
        self.sessions = dict(zip(nodes, opened))
        return {**self.test, "sessions": self.sessions}

    def close(self):
        for s in self.sessions.values():
            try:
                control.disconnect(s)
            except Exception:  # noqa: BLE001
                pass

    def __exit__(self, *exc):
        self.close()


def snarf_logs(test: dict) -> None:
    """Download DB log files into the store directory (core.clj:102-136)."""
    db = test.get("db")
    store_dir = test.get("store_dir")
    if not isinstance(db, jdb.LogFiles) or not store_dir:
        return

    def snarf(t, node):
        from .control import nodeutil as cu
        for remote in db.log_files(t, node):
            if cu.file_exists(remote):
                local = os.path.join(store_dir, str(node),
                                     remote.lstrip("/"))
                os.makedirs(os.path.dirname(local), exist_ok=True)
                try:
                    control.download(remote, local)
                except Exception as e:  # noqa: BLE001
                    log.info("couldn't download %s: %s", remote, e)

    log.info("Snarfing log files")
    control.on_nodes(test, snarf)


def run_case(test: dict) -> list:
    """Set up nemesis (concurrently) + clients, run the interpreter,
    tear everything down (core.clj:183-219)."""
    client = test["client"]
    nemesis = jnemesis.validate(test.get("nemesis") or jnemesis.noop())
    with ThreadPoolExecutor(max_workers=1) as pool:
        nemesis_fut = pool.submit(nemesis.setup, test)

        def open_and_setup(node):
            c = client.open(test, node)
            c.setup(test)
            return c

        clients = util.real_pmap(open_and_setup, test.get("nodes") or [])
        nemesis = nemesis_fut.result()
    test = {**test, "nemesis": nemesis}
    try:
        return interpreter.run(test)
    finally:
        with ThreadPoolExecutor(max_workers=1) as pool:
            td = pool.submit(nemesis.teardown, test)

            def teardown_client(c):
                try:
                    c.teardown(test)
                finally:
                    c.close(test)

            util.real_pmap(teardown_client, clients)
            td.result()


def analyze(test: dict) -> dict:
    """Index the history and run the checker (core.clj:221-237): the
    test map with "history" an indexed `History` and "results"."""
    log.info("Analyzing...")
    history = test["history"]
    if not isinstance(history, History):
        history = History(history)
    history = history.index()
    test = {**test, "history": history}
    test["results"] = jchecker.check_safe(
        test.get("checker") or jchecker.unbridled_optimism(),
        test, history, {})
    log.info("Analysis complete")
    return test


def log_results(test: dict) -> dict:
    """core.clj:239-252."""
    valid = test.get("results", {}).get("valid?")
    if valid is False:
        verdict = "Analysis invalid! (ノಥ益ಥ）ノ ┻━┻"
    elif valid == "unknown":
        verdict = ("Errors occurred during analysis, "
                   "but no anomalies found. ಠ~ಠ")
    else:
        verdict = "Everything looks good! ヽ('ー`)ノ"
    log.info("%r\n\n%s", test.get("results"), verdict)
    return test


def run(test: dict) -> dict:
    """Run a complete test; returns the test map with "history" and
    "results" (core.clj:327-406). See module docstring for phases."""
    test = prepare_test(test)

    from . import fleet, store
    from . import ledger as ledger_mod
    from . import watchdog as watchdog_mod
    t_run0 = _time.monotonic()
    writer = store.Writer(test) if test.get("name") else None
    # Live run status (fleet.RunStatus): ambient
    # for the whole run — the interpreter, checker phase spans, and the
    # device fan-out all update it; `serve` exposes it at /status.json.
    # Updates land at poll/key boundaries only, so this is always on.
    # The throttled file mirror under the STORE ROOT lets an
    # out-of-process `serve` watch the run live.
    status_file = (os.path.join(test.get("store_root") or store.BASE_DIR,
                                fleet.STATUS_FILENAME)
                   if writer else None)
    status = fleet.RunStatus(test=test.get("name"),
                             status_file=status_file)
    prev_status = fleet.set_default(status)
    # Run-ledger + stall-watchdog accounting:
    # named runs append per-analysis + per-run records under the store
    # root's ledger/, and a heartbeat watchdog surveils the device
    # loops so a hang INSIDE a device round is detected and recorded
    # instead of blocking silently. Both restore the previous ambient
    # defaults on exit.
    prev_ledger = ledger_mod.set_default(
        ledger_mod.Ledger(test.get("store_root") or store.BASE_DIR)
        if writer else ledger_mod.get_default())
    # Device observatory (devices.py): per-run device-memory accounting
    # sampled at the kernels' existing poll cadences (it never
    # initialises CUDA) — /status.json's `hbm` block and
    # hbm_peak_measured on results read from this ambient monitor.
    from . import devices as devices_mod
    prev_devmon = devices_mod.set_default(devices_mod.DeviceMonitor())
    wd_installed = None
    if not watchdog_mod.get_default().enabled:
        wd_installed = watchdog_mod.Watchdog()
        prev_wd = watchdog_mod.set_default(wd_installed)
    if writer:
        test["store_dir"] = writer.dir
        store.start_logging(test)
    try:
        if writer:
            writer.save_0(test)
        remote_ctx = control.with_remote(test["remote"]) \
            if test.get("remote") is not None else None
        with (remote_ctx or _nullcontext()):
            with control.with_ssh(test.get("ssh")):
                with _Sessions(test) as test:
                    os_obj = test.get("os")
                    try:
                        if os_obj:
                            control.on_nodes(
                                test, lambda t, n: os_obj.setup(t, n))
                        try:
                            if test.get("db"):
                                jdb.cycle(test)
                            status.phase("run")
                            with util.with_relative_time():
                                test = {**test,
                                        "history": run_case(test)}
                            log.info("Run complete, writing")
                            if writer:
                                writer.save_1(test)
                            snarf_logs(test)
                        finally:
                            if test.get("db") and not test.get(
                                    "leave_db_running?"):
                                db = test["db"]
                                control.on_nodes(
                                    test, lambda t, n: db.teardown(t, n))
                    finally:
                        if os_obj:
                            control.on_nodes(
                                test, lambda t, n: os_obj.teardown(t, n))
                    status.phase("analyze")
                    test = analyze(test)
                    if writer:
                        writer.save_2(test)
        return log_results(test)
    finally:
        valid = (test.get("results") or {}).get("valid?")
        status.finish(valid=valid)
        fleet.set_default(prev_status)
        # a test-map tracer's spans land in the run dir (trace.clj +
        # trace.py) — in the outer finally so crashed runs (when the trace matters most)
        # still export, and guarded so a broken tracer can't void the
        # run's other artifacts
        tracer = test.get("tracer")
        artifacts = {}
        if tracer is not None and writer:
            try:
                n = tracer.export(os.path.join(writer.dir,
                                               "trace.jsonl"))
                # the same spans in Chrome/Perfetto trace_event form:
                # drop the file in ui.perfetto.dev and the run's
                # encode/compile/device-round/fan-out phases render as
                # a flame chart, with the occupancy plane's
                # fill/frontier/backlog series embedded as counter
                # tracks under the spans
                from . import metrics as metrics_mod
                from . import occupancy as occupancy_mod
                tracer.export_perfetto(
                    os.path.join(writer.dir, "trace.perfetto.json"),
                    counters=occupancy_mod.perfetto_counter_tracks(
                        metrics_mod.get_default()))
                log.info("Exported %d spans", n)
                root = test.get("store_root") or store.BASE_DIR
                artifacts = {
                    "trace": os.path.relpath(
                        os.path.join(writer.dir, "trace.jsonl"), root),
                    "perfetto": os.path.relpath(
                        os.path.join(writer.dir,
                                     "trace.perfetto.json"), root)}
            except Exception:  # noqa: BLE001
                log.warning("trace export failed", exc_info=True)
        led = ledger_mod.get_default()
        if writer and led.enabled:
            # the run-level ledger record: per-analysis records were
            # appended by the checkers; this one ties them to the run
            # dir, the verdict, and the end-to-end wall
            try:
                root = test.get("store_root") or store.BASE_DIR
                wd_now = watchdog_mod.get_default()
                led.record({
                    "kind": "run", "name": test.get("name"),
                    "verdict": valid,
                    "wall_s": round(_time.monotonic() - t_run0, 4),
                    "ops": len(test.get("history") or []),
                    "stalls": len(wd_now.stalls) if wd_now.enabled
                    else 0,
                    "artifacts": {
                        "dir": os.path.relpath(writer.dir, root),
                        **artifacts}})
            except Exception:  # noqa: BLE001
                log.warning("ledger record failed", exc_info=True)
        ledger_mod.set_default(prev_ledger)
        devices_mod.set_default(prev_devmon)
        if wd_installed is not None:
            wd_installed.stop()
            watchdog_mod.set_default(prev_wd)
        if writer:
            store.stop_logging()
            writer.close()


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
