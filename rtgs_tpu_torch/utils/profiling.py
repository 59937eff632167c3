"""Profiling and observability (port of :mod:`rtgs_tpu.utils.profiling`).

* :func:`timed` — median wall time of a call, waiting for every card that
  holds a tensor of its result (as ``jax.block_until_ready`` waits on
  every leaf), with rays/s where given;
* :func:`trace` — a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) exported as a Chrome trace into a log directory,
  which it yields;
* :class:`Meter` — rolling per-step metrics for structured log lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out``: a tensor, or a
    dataclass, tuple (NamedTuples too), list or dict holding them, nested
    to any depth."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    return found


def _sync(out) -> None:
    """Wait for each card that holds a tensor of ``out``, once."""
    for dev in sorted(_cuda_devices(out, set()), key=str):
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1,
          rays: Optional[int] = None, label: str = "") -> Dict[str, float]:
    """Median wall time of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each ending when its result is ready; optional rays/s.
    Returns ``median_s``, ``min_s``, ``max_s`` (and ``rays_per_s``)."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    out = {"median_s": med, "min_s": times[0], "max_s": times[-1]}
    if rays:
        out["rays_per_s"] = rays / med
    if label:
        msg = f"{label}: {med * 1e3:.2f} ms"
        if rays:
            msg += f" ({rays / med / 1e6:.2f}M rays/s)"
        logger.info(msg)
    return out


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` over the block, CPU activity and, where a card is
    present, CUDA activity; the Chrome trace (view it in Perfetto or
    ``chrome://tracing``) goes to ``logdir/trace.json``. ``logdir``
    defaults to ``rtgs_torch_trace`` in the temporary directory (``/tmp``
    unless ``TMPDIR`` says otherwise), as the JAX package's defaults to
    ``/tmp/rtgs_tpu_trace``. Yields ``logdir``, as the JAX package's
    does."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "rtgs_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Meter:
    """Rolling aggregation of scalar metrics for periodic structured logs."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, **metrics: float) -> None:
        self._steps += 1
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def flush(self, step: int, rays_per_step: Optional[int] = None) -> str:
        dt = time.perf_counter() - self._t0
        per_step = dt / max(self._steps, 1)
        parts = [f"step {step}", f"{per_step * 1e3:.1f} ms/step"]
        if rays_per_step:
            parts.append(
                f"{rays_per_step * self._steps / dt / 1e6:.2f}M rays/s")
        for k in sorted(self._sums):
            parts.append(f"{k}={self._sums[k] / self._counts[k]:.5g}")
        line = " ".join(parts)
        logger.info(line)
        self._sums.clear()
        self._counts.clear()
        self._steps = 0
        self._t0 = time.perf_counter()
        return line
