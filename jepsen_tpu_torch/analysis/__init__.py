"""Host-side analysis: the static and runtime planes around the checkers.

  * `history_lint` — the well-formedness pass over histories, run
                     before every WGL/Elle search;
  * `guards`       — the runtime compile and transfer guards
                     (`CompileGuard`);
  * `preflight`    — the static kernel-plan and capacity analyzer
                     (admission control, P001-P006);
  * `kernellint`   — the kernel-host lint over the launch wrappers and
                     poll loops (K001-K008; the reference's `jaxlint`);
  * `threadlint`   — the thread-safety lint over the threaded host
                     plane (T001-T008);
  * `lockwatch`    — the runtime lock-order witness, armed by
                     JEPSEN_TPU_LOCKWATCH=1;
  * `gitscope`     — the lint CLIs' shared `--changed-only` scoping.

Each is imported on first use (`from jepsen_tpu_torch.analysis import
threadlint`), so importing the package costs nothing and `python -m
jepsen_tpu_torch.analysis.threadlint` / `.kernellint` run their module
once.
"""

import importlib

__all__ = ["gitscope", "guards", "history_lint", "kernellint", "lockwatch",
           "preflight", "threadlint"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
