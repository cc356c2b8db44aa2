"""The scheduler hot loop: evaluates a pure generator against real
clients and a nemesis, journaling a history.

Capability parity with jepsen.generator.interpreter
(`jepsen/src/jepsen/generator/interpreter.clj`): one OS thread per worker
(a worker per client thread plus the nemesis), each fed through a
size-1 mailbox queue; a single-threaded scheduler loop that polls a
shared completion queue, asks the generator for ops, dispatches them,
retimestamps events with the relative-time clock, reassigns crashed
processes, and collects the history (interpreter.clj:181-310).

Workers apply ops via the test's Client (one fresh client per process
unless Reusable — ClientWorker, interpreter.clj:33-67) or Nemesis.
Worker crashes become :info completions with the exception attached
(interpreter.clj:141-160).

The port's copy of `jepsen_tpu/generator/interpreter.py`.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time as _time
import traceback
from dataclasses import replace
from typing import Any, Optional

from .. import client as jclient
from .. import util
from . import (NEMESIS, PENDING, Context)
from . import context as make_context
from . import friendly_exceptions
from . import op as gen_op
from . import update as gen_update
from . import validate as gen_validate

log = logging.getLogger("jepsen_tpu_torch.interpreter")

MAX_PENDING_INTERVAL_S = 0.001  # 1000 µs (interpreter.clj:166-170)


class Worker:
    """Lifecycle protocol for stateful workers (interpreter.clj:19-31).
    All calls on one Worker happen on a single thread."""

    def open(self, test: dict, wid) -> "Worker":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def close(self, test: dict) -> None:
        return None


class ClientWorker(Worker):
    """Wraps a Client; opens a fresh one for each new process unless the
    client is Reusable (interpreter.clj:33-67)."""

    def __init__(self, node: str):
        self.node = node
        self.process = None
        self.client: Optional[jclient.Client] = None

    def invoke(self, test, op):
        if self.process != op.get("process") and not (
                self.client is not None
                and jclient.is_validate_reusable(self.client, test)):
            # New process, new client
            self.close(test)
            try:
                self.client = jclient.validate(test["client"]).open(
                    test, self.node)
                self.process = op.get("process")
            except Exception as e:  # noqa: BLE001
                log.warning("Error opening client: %s", e)
                self.client = None
                return {**op, "type": "fail",
                        "error": ["no-client", str(e)]}
        return self.client.invoke(test, op)

    def close(self, test):
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker(Worker):
    def invoke(self, test, op):
        return test["nemesis"].invoke(test, op)


class ClientNemesisWorker(Worker):
    """Spawns per-id workers: clients for integer ids (round-robin over
    nodes), the nemesis otherwise (interpreter.clj:78-95)."""

    def open(self, test, wid):
        if isinstance(wid, int):
            nodes = test.get("nodes") or [None]
            return ClientWorker(nodes[wid % len(nodes)])
        return NemesisWorker()


def client_nemesis_worker() -> ClientNemesisWorker:
    return ClientNemesisWorker()


def _worker_loop(test, worker: Worker, wid, inbox: _queue.Queue,
                 out: _queue.Queue):
    """Worker thread body (interpreter.clj:99-164)."""
    try:
        while True:
            op = inbox.get()
            t = op.get("type")
            if t == "exit":
                return
            if t == "sleep":
                _time.sleep(op["value"])
                out.put(op)
                continue
            if t == "log":
                log.info("%s", op["value"])
                out.put(op)
                continue
            try:
                out.put(worker.invoke(test, op))
            except Exception as e:  # noqa: BLE001
                log.warning("Process %r crashed: %s", op.get("process"), e)
                out.put({**op, "type": "info",
                         "exception": traceback.format_exc(),
                         "error": f"indeterminate: {e}"})
    finally:
        worker.close(test)


class _WorkerHandle:
    def __init__(self, test, worker_factory, wid, completions):
        self.id = wid
        self.inbox: _queue.Queue = _queue.Queue(maxsize=1)
        worker = worker_factory.open(test, wid)
        # convey the spawning thread's control bindings (remote, ssh
        # config) into the worker, as Clojure's binding conveyance does
        # for the reference's worker futures — the nemesis runs control
        # actions from its worker thread (interpreter.clj:99-116)
        from .. import control
        self.thread = threading.Thread(
            target=control.bound_fn(_worker_loop),
            args=(test, worker, wid, self.inbox, completions),
            name=f"jepsen-worker-{wid}", daemon=True)
        self.thread.start()


def run(test: dict):
    """Evaluate all ops from test["generator"], returning the history as
    a list of op dicts (interpreter.clj:181-310). The caller wraps this
    with the relative-time clock (util.with_relative_time)."""
    from .. import fleet as _fleet
    status = _fleet.get_default()
    ctx = make_context(test)
    completions: _queue.Queue = _queue.Queue()
    factory = client_nemesis_worker()
    workers = {wid: _WorkerHandle(test, factory, wid, completions)
               for wid in ctx.all_threads()}
    gen = gen_validate(friendly_exceptions(test.get("generator")))
    history: list = []
    outstanding = 0
    poll_timeout = 0.0

    def goes_in_history(op):
        return op.get("type") not in ("sleep", "log")

    try:
        while True:
            # Prefer completions: they're latency-sensitive.
            op2 = None
            try:
                op2 = completions.get(block=poll_timeout > 0,
                                      timeout=poll_timeout or None)
            except _queue.Empty:
                op2 = None
            if op2 is not None:
                thread = ctx.process_to_thread(op2.get("process"))
                now = util.relative_time_nanos()
                op2 = {**op2, "time": now}

                ctx = replace(ctx, time=now,
                              free_threads=ctx.free_threads | {thread})
                gen = gen_update(gen, test, ctx, op2)
                if thread != NEMESIS and op2.get("type") == "info":
                    workers_map = dict(ctx.workers)
                    workers_map[thread] = ctx.next_process(thread)
                    ctx = replace(ctx, workers=workers_map)
                if goes_in_history(op2):
                    history.append(op2)
                    if status.enabled:
                        status.op_event(invoked=False)
                outstanding -= 1
                poll_timeout = 0.0
                continue


            now = util.relative_time_nanos()
            ctx = replace(ctx, time=now)
            res = gen_op(gen, test, ctx)
            if res is None:
                if outstanding > 0:
                    poll_timeout = MAX_PENDING_INTERVAL_S
                    continue
                break
            op, gen2 = res
            if op is PENDING:
                # NB: the post-PENDING generator is discarded, exactly as
                # the reference recurs with the pre-op gen
                # (interpreter.clj:264-265)
                poll_timeout = MAX_PENDING_INTERVAL_S
                continue
            if now < op["time"]:
                # Not time yet; wait for either a completion or the
                # op's scheduled time.
                poll_timeout = min((op["time"] - now) / 1e9,
                                   MAX_PENDING_INTERVAL_S)
                continue
            thread = ctx.process_to_thread(op.get("process"))
            workers[thread].inbox.put(op)
            ctx = replace(ctx, time=op["time"],
                          free_threads=ctx.free_threads - {thread})
            gen = gen_update(gen2, test, ctx, op)
            if goes_in_history(op):
                history.append(op)
                if status.enabled:
                    status.op_event(invoked=True)
                    if thread == NEMESIS:
                        status.nemesis_event(
                            op.get("f"),
                            active=_fleet.nemesis_opens_window(
                                op.get("f")))
            outstanding += 1
            poll_timeout = 0.0
    finally:
        for w in workers.values():
            w.inbox.put({"type": "exit"})
        for w in workers.values():
            w.thread.join(timeout=10)
    return history
