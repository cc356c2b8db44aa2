"""jepsen_tpu_torch: the PyTorch/CUDA port of jepsen_tpu's checkers.

A second package beside the JAX reference `jepsen_tpu`: it imports
torch and numpy, never jax and nothing of `jepsen_tpu`, and keeps its
own copies of the host modules it needs. Entry points run on the CUDA
card unless the caller passes `device="cpu"`.

    from jepsen_tpu_torch import checker, synth
    from jepsen_tpu_torch.models import cas_register
    h = synth.cas_register_history(10000, n_procs=5, seed=42, crash_p=0.002)
    checker.linearizable(cas_register()).check({}, h, {})

    from jepsen_tpu_torch.elle import append
    h = synth.list_append_history(3000, n_procs=5, seed=7)
    append.check(h, additional_graphs=("realtime",))
"""
