"""Long-fork anomaly workload (parallel snapshot isolation).

Capability parity with jepsen.tests.long-fork
(`jepsen/src/jepsen/tests/long_fork.clj:1-332`): write txns insert a
single unique key; read txns read that key's whole group of n keys.
Serializability requires a total order over reads of a group —
mutually incomparable reads (one sees x-not-y, another y-not-x) form a
long fork. The checker compares every read pair per group; multiple
writes to one key make the history uncheckable ("unknown").

Micro-ops use the txn algebra ([f k v] lists, `jepsen_tpu_torch.txn`).

The port's copy of `jepsen_tpu/workloads/long_fork.py`.
"""

from __future__ import annotations

from typing import Optional

from .. import generator as gen
from .. import txn as txn_mod
from ..checker import UNKNOWN, Checker


def group_for(n: int, k: int) -> range:
    """The n-key group containing k (long_fork.clj:97-104)."""
    lower = k - (k % n)
    return range(lower, lower + n)


def read_txn_for(n: int, k: int) -> list:
    """A read txn over k's group, shuffled (long_fork.clj:106-112)."""
    ks = list(group_for(n, k))
    gen.RNG.shuffle(ks)
    return [[txn_mod.R, kk, None] for kk in ks]


class Generator(gen.Generator):
    """Single writes of fresh keys, then a group read from the same
    worker; plus random reads of other in-flight groups
    (long_fork.clj:114-154)."""

    def __init__(self, n: int, next_key: int = 0,
                 workers: Optional[dict] = None):
        self.n = n
        self.next_key = next_key
        self.workers = workers or {}  # thread -> last written key

    def op(self, test, ctx):
        process = ctx.some_free_process()
        if process is None:
            return (gen.PENDING, self)
        worker = ctx.process_to_thread(process)
        k = self.workers.get(worker)
        if k is not None:
            # we wrote a key; read its group and clear
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k)}, ctx)
            return (op, Generator(self.n, self.next_key,
                                  {**self.workers, worker: None}))
        active = [v for v in self.workers.values() if v is not None]
        if active and gen.RNG.random() < 0.5:
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, gen.RNG.choice(active))},
                ctx)
            return (op, self)
        op = gen.fill_in_op(
            {"process": process, "f": "write",
             "value": [[txn_mod.W, self.next_key, 1]]}, ctx)
        return (op, Generator(self.n, self.next_key + 1,
                              {**self.workers, worker: self.next_key}))

    def update(self, test, ctx, event):
        return self


def generator(n: int) -> Generator:
    return Generator(n)


class IllegalHistory(Exception):
    def __init__(self, msg, **info):
        super().__init__(msg)
        self.info = {"msg": msg, **info}


def read_compare(a: dict, b: dict):
    """-1 if a dominates, 0 if equal, 1 if b dominates, None if
    incomparable (long_fork.clj:156-196). Values move away from None
    exactly once; distinct non-None values for one key are illegal."""
    if set(a) != set(b):
        raise IllegalHistory(
            "These reads did not query for the same keys, and therefore "
            "cannot be compared.", reads=[a, b])
    res = 0
    for k in a:
        va, vb = a[k], b[k]
        if va == vb:
            continue
        if vb is None:      # a bigger here
            if res > 0:
                return None
            res = -1
        elif va is None:    # b bigger here
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                "These two read states contain distinct values for the "
                "same key; this checker assumes only one write occurs "
                "per key.", key=k, reads=[a, b])
    return res


def read_op_value_map(op) -> dict:
    return {m[1]: m[2] for m in (op.value or [])}


def find_forks(ops) -> list:
    """Mutually incomparable read pairs (long_fork.clj:208-217)."""
    forks = []
    for i in range(len(ops)):
        for j in range(i + 1, len(ops)):
            if read_compare(read_op_value_map(ops[i]),
                            read_op_value_map(ops[j])) is None:
                forks.append([ops[i], ops[j]])
    return forks


def is_read_txn(txn) -> bool:
    return all(txn_mod.is_read(m) for m in txn)


def is_write_txn(txn) -> bool:
    return len(txn) == 1 and txn_mod.is_write(txn[0])


def op_read_keys(op) -> frozenset:
    return frozenset(m[1] for m in (op.value or []))


def groups(n: int, read_ops) -> list:
    """Partition reads by key-group; wrong-width groups are illegal
    (long_fork.clj:225-239)."""
    by_group: dict = {}
    for op in read_ops:
        by_group.setdefault(op_read_keys(op), []).append(op)
    out = []
    for ks, ops in by_group.items():
        if len(ks) != n:
            raise IllegalHistory(
                f"Every read in this history should have observed "
                f"exactly {n} keys, but this read observed {len(ks)} "
                f"instead: {sorted(ks)}", op=ops[0])
        out.append(ops)
    return out


class LongForkChecker(Checker):
    """No key written twice; no mutually incomparable group reads
    (long_fork.clj:241-311)."""

    def __init__(self, n: int):
        self.n = n

    def check(self, test, history, opts=None):
        reads = [op for op in history
                 if op.is_ok and is_read_txn(op.value or [])]
        early = [r for r in reads
                 if not any(m[2] is not None for m in r.value)]
        late = [r for r in reads
                if all(m[2] is not None for m in r.value)]
        out = {"reads-count": len(reads),
               "early-read-count": len(early),
               "late-read-count": len(late)}
        # multiple writes to one key -> unknown (long_fork.clj:258-274)
        written: set = set()
        for op in history:
            if op.is_invoke and is_write_txn(op.value or []):
                k = op.value[0][1]
                if k in written:
                    return {**out, "valid?": UNKNOWN,
                            "error": ["multiple-writes", k]}
                written.add(k)
        try:
            forks = []
            for grp in groups(self.n, reads):
                forks.extend(find_forks(grp))
        except IllegalHistory as e:
            return {**out, "valid?": UNKNOWN, "error": e.info}
        if forks:
            return {**out, "valid?": False,
                    "forks": [[a.to_dict(), b.to_dict()]
                              for a, b in forks]}
        return {**out, "valid?": True}


def checker(n: int) -> Checker:
    return LongForkChecker(n)


def workload(n: int = 2) -> dict:
    """Checker + generator bundle; n = group size
    (long_fork.clj:313-332). The generator is client-scoped: unwrapped,
    some_free_process could hand a write txn to the nemesis."""
    return {"checker": checker(n),
            "generator": gen.clients(generator(n))}
