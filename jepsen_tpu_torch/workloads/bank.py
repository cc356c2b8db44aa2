"""Bank-transfer workload: total balance must be conserved.

Capability parity with jepsen.tests.bank
(`jepsen/src/jepsen/tests/bank.clj:20-192`): transfer ops move a
random amount between distinct random accounts; read ops return the
full {account: balance} map. The checker validates every ok read —
unexpected accounts, nil balances, totals drifting from total-amount,
and (unless negative_balances is allowed) negative balances — with the
reference's error taxonomy, first/worst/last examples, and badness
ranking. The plotter draws total-balance-over-time per node.

Test map options: "accounts", "total-amount", "max-transfer",
(bank.clj:1-8).

The port's copy of `jepsen_tpu/workloads/bank.py`. Where matplotlib is
not installed (as on the card's machine) `plots._plt` is None and the
plotter answers valid without writing `bank.png`.
"""

from __future__ import annotations

from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from ..checker import Checker
from ..checker.plots import _plt, _save


def read(test, ctx):
    return {"f": "read", "value": None}


def transfer(test, ctx):
    accounts = test["accounts"]
    return {"f": "transfer",
            "value": {"from": gen.RNG.choice(accounts),
                      "to": gen.RNG.choice(accounts),
                      "amount": 1 + gen.RNG.randrange(
                          test["max-transfer"])}}


diff_transfer = gen.filter_(
    lambda op: op["value"]["from"] != op["value"]["to"], transfer)


def generator():
    """Mixed reads and distinct-account transfers (bank.clj:40-44)."""
    return gen.mix([diff_transfer, read])


def err_badness(test, err: dict):
    """Bigger numbers = more egregious errors (bank.clj:46-54)."""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        return abs((err["total"] - test["total-amount"])
                   / test["total-amount"])
    if t == "negative-value":
        return -sum(err["negative"])
    return 0


def check_op(accts: set, total, negative_balances: bool, op) -> Optional[dict]:
    """Errors in one read's balance map (bank.clj:56-86)."""
    value = op.value or {}
    ks = list(value.keys())
    balances = list(value.values())
    if not all(k in accts for k in ks):
        return {"type": "unexpected-key",
                "unexpected": [k for k in ks if k not in accts],
                "op": op}
    if any(b is None for b in balances):
        return {"type": "nil-balance",
                "nils": {k: v for k, v in value.items() if v is None},
                "op": op}
    if sum(balances) != total:
        return {"type": "wrong-total", "total": sum(balances), "op": op}
    if not negative_balances and any(b < 0 for b in balances):
        return {"type": "negative-value",
                "negative": [b for b in balances if b < 0],
                "op": op}
    return None


class BankChecker(Checker):
    """All reads sum to total-amount; balances non-negative unless
    allowed (bank.clj:88-121)."""

    def __init__(self, negative_balances: bool = False):
        self.negative_balances = negative_balances

    def check(self, test, history, opts=None):
        accts = set(test["accounts"])
        total = test["total-amount"]
        reads = [op for op in history if op.is_ok and op.f == "read"]
        errors: dict = {}
        for op in reads:
            err = check_op(accts, total, self.negative_balances, op)
            if err is not None:
                errors.setdefault(err["type"], []).append(err)
        first_error = None
        firsts = [v[0] for v in errors.values()]
        if firsts:
            first_error = min(firsts, key=lambda e: e["op"].index)
        out_errors = {}
        for typ, errs in errors.items():
            d = {"count": len(errs),
                 "first": errs[0],
                 "worst": max(errs,
                              key=lambda e: err_badness(test, e)),
                 "last": errs[-1]}
            if typ == "wrong-total":
                d["lowest"] = min(errs, key=lambda e: e["total"])
                d["highest"] = max(errs, key=lambda e: e["total"])
            out_errors[typ] = d
        return {"valid?": not errors,
                "read-count": len(reads),
                "error-count": sum(len(v) for v in errors.values()),
                "first-error": first_error,
                "errors": out_errors}


def checker(negative_balances: bool = False) -> Checker:
    return BankChecker(negative_balances)


class Plotter(Checker):
    """bank.png: total of all accounts over time, one series per node
    (bank.clj:123-176)."""

    def check(self, test, history, opts=None):
        reads = [op for op in history
                 if op.is_ok and op.f == "read"
                 and isinstance(op.process, int) and op.value]
        if not reads:
            return {"valid?": True}
        nodes = test.get("nodes") or []
        # crashed processes get fresh ids offset by concurrency, so map
        # process -> original worker thread first (interpreter assigns
        # node = nodes[thread % len(nodes)])
        conc = test.get("concurrency") or len(nodes) or 1
        by_node: dict = {}
        for op in reads:
            node = nodes[(op.process % conc) % len(nodes)] if nodes \
                else str(op.process)
            by_node.setdefault(node, []).append(
                (op.time / 1e9,
                 sum(v for v in op.value.values() if v is not None)))
        plt = _plt()
        if plt is None:
            return {"valid?": True}
        fig, ax = plt.subplots(figsize=(10, 4))
        for node in sorted(by_node):
            xs, ys = zip(*by_node[node])
            ax.scatter(xs, ys, s=10, marker="x", label=str(node))
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Total of all accounts")
        ax.set_title(f"{test.get('name', '')} bank")
        ax.legend(loc="upper right", fontsize=8)
        _save(fig, test, opts, "bank.png")
        plt.close(fig)
        return {"valid?": True}


def plotter() -> Checker:
    return Plotter()


def workload(opts: Optional[dict] = None) -> dict:
    """Defaults + generator + checker bundle (bank.clj:178-192); merge
    the returned map into the test map (it carries accounts /
    total-amount / max-transfer keys the client and checker read)."""
    opts = opts or {}
    negative = opts.get("negative_balances", False)
    return {
        "max-transfer": 5,
        "total-amount": 100,
        "accounts": list(range(8)),
        "checker": jchecker.compose({"SI": checker(negative),
                                     "plot": plotter()}),
        "generator": generator(),
    }
