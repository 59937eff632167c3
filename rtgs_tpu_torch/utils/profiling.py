"""Profiling and observability (port of :mod:`rtgs_tpu.utils.profiling`).

* :func:`timed` — median wall time of a call, synchronizing the card when
  its result lies there, with rays/s where given;
* :func:`trace` — a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) exported as a Chrome trace;
* :class:`Meter` — rolling per-step metrics for structured log lines.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def _sync(out) -> None:
    """Wait for the card if any tensor in ``out`` (a tensor, or a tuple,
    list or dict of them) lies on it."""
    if isinstance(out, torch.Tensor):
        tensors = [out]
    elif isinstance(out, dict):
        tensors = list(out.values())
    elif isinstance(out, (tuple, list)):
        tensors = list(out)
    else:
        tensors = []
    for x in tensors:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)


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
def trace(logdir: str = "rtgs_torch_trace"):
    """``torch.profiler`` over the block, CPU activity and, where a card is
    present, CUDA activity; the Chrome trace (view it in Perfetto or
    ``chrome://tracing``) goes to ``logdir/trace.json``. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield prof
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
