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

The JAX package's production-scale tools, each a function and a program,
with no kernel of their own:

  * :mod:`~rtgs_tpu_torch.probes.make_scene` — the structured scene and
    each tile's candidate count;
  * :mod:`~rtgs_tpu_torch.probes.fitbench` — the recovery fit;
  * :mod:`~rtgs_tpu_torch.probes.fitscratch` — the fit from a sparse seed
    with density control;
  * :mod:`~rtgs_tpu_torch.probes.imquality` — full-frame image quality
    against the twins and the oracle;
  * :mod:`~rtgs_tpu_torch.probes.trace_step` — a profiler trace of
    training steps;
  * :mod:`~rtgs_tpu_torch.probes.stages` — the stage split of the keys and
    fused paths.
"""
