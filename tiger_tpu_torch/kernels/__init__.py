"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers.

``rk45`` (B1) and ``radau`` (B2) each launch their kernel for CUDA tensors
and run their plain PyTorch version for CPU tensors.  The modules are
imported lazily by the solvers; importing them builds nothing (``_build``
compiles the library at the first CUDA launch).
"""


def launch_counts() -> dict:
    """{"rk45": {instance: launches}, "radau": {...}}: each wrapper adds one
    where it launches its kernel, and nowhere else."""
    from tiger_tpu_torch.kernels import radau, rk45

    return {"rk45": dict(rk45.rk45_launches), "radau": dict(radau.radau_launches)}


def option_launch_counts() -> dict:
    """{option: launches}: B1's launches with each of its runtime options
    (the lockstep query crossing, bf16 forcing), by model and scalar; each
    also counts in ``launch_counts`` under its instance.  (B2's factor
    reuse is an instance of its own.)"""
    from tiger_tpu_torch.kernels import rk45

    return dict(rk45.rk45_option_launches)


def launch_totals() -> dict:
    """{"rk45": launches, "radau": launches} over all instances."""
    return {kernel: sum(counts.values()) for kernel, counts in launch_counts().items()}


def reset_launch_counts() -> None:
    """Set every instance's and every runtime option's launch count to 0."""
    from tiger_tpu_torch.kernels import radau, rk45

    for counts in (rk45.rk45_launches, radau.radau_launches, rk45.rk45_option_launches):
        counts.update(dict.fromkeys(counts, 0))
