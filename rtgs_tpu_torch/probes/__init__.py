"""Kernel probes of the port: microbenchmarks and ablations at the peel
kernels' launch shape, each runnable as
``python -m rtgs_tpu_torch.probes.<name>``:

  * :mod:`~rtgs_tpu_torch.probes.kmicro` — single-operation kernels on a
    (T, P, C) block (``ops/csrc/probe_micro.cu``);
  * :mod:`~rtgs_tpu_torch.probes.kprobe` — ablations of the fused forward
    peel at a scene (``ops/csrc/probe_ablate.cu``);
  * :mod:`~rtgs_tpu_torch.probes.lpprobe` — the keys kernel in its output
    layouts, and the floor kernels of its launch shape
    (``ops/csrc/probe_floor.cu``);
  * :mod:`~rtgs_tpu_torch.probes.ktime` — the production kernels' times at
    the bench shapes, with and without the wrapper's host time, optionally
    from an edited copy of the sources (CUDA only; it has no kernel of its
    own).

Every variant is a function with a defined result; beside each kernel
stands a plain torch version, which the wrappers take for CPU tensors only.
"""
