"""Consistency models for linearizability checking.

Reproduces the capability of knossos.model (an external dependency of the
reference, `jepsen/project.clj:7-33`; the protocol and cas-register model
are reproduced verbatim in the reference's tutorial,
`doc/tutorial/04-checker.md:38-95`): a model is an immutable value with a
single operation `step(op) -> model | Inconsistent`.

Two forms per model:
  * the object form here (pure Python, the correctness oracle and the
    public API), and
  * the integer transition table `ops.encode.build_table` derives from
    it for the CUDA search kernel.

This package keeps its own copy of the JAX package's models so that
`build_table` gives the same transition table in both.
"""

from .core import (
    Model,
    Inconsistent,
    inconsistent,
    is_inconsistent,
    Register,
    CASRegister,
    MultiRegister,
    Mutex,
    FIFOQueue,
    UnorderedQueue,
    NoOp,
    register,
    cas_register,
    multi_register,
    mutex,
    fifo_queue,
    unordered_queue,
    noop,
)

__all__ = [
    "Model",
    "Inconsistent",
    "inconsistent",
    "is_inconsistent",
    "Register",
    "CASRegister",
    "MultiRegister",
    "Mutex",
    "FIFOQueue",
    "UnorderedQueue",
    "NoOp",
    "register",
    "cas_register",
    "multi_register",
    "mutex",
    "fifo_queue",
    "unordered_queue",
    "noop",
]
