"""Profiling and observability (port of :mod:`rtgs_tpu.utils.profiling`).

* :func:`timed` — median wall time of a call, waiting for every card that
  holds a tensor of its result (as ``jax.block_until_ready`` waits on
  every leaf), with rays/s where given;
* :func:`trace` — a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) exported as a Chrome trace into a log directory,
  which it yields;
* :func:`span` and :func:`count` — the program's own spans at its layer
  boundaries and its work counters, recorded in memory only while a
  ``torch.profiler`` session records (:func:`trace` is one); :func:`read`
  totals them by name and :func:`clear` empties the record.

A live span is also a ``record_function("rtgs.<name>")`` annotation, so it
sits in the Chrome trace on the clock of the device operations; on a card
it records a pair of CUDA events on the current stream, whose interval is
its *stream ms*: how long the layer held the stream, busy or waiting for
the host's next launch. Events and counted device tensors are resolved
only by :func:`read`, so a profiled window launches nothing and waits for
nothing more than the program does. With no profiler recording, a span is
one check and a shared null context, a count one check; neither enters
``record_function``, which costs microseconds even with the profiler off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import tempfile
import threading
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


# ----- the program's spans and counters -----

PREFIX = "rtgs."            # the spans' names in a profiler trace
_OFF = contextlib.nullcontext()


class _Record:
    """What the spans and counters recorded: closed spans in closing order,
    and per counter name its host total followed by the tensors kept by
    reference until :func:`read` reduces them."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.counters: dict[str, list] = {}
        self.tops = itertools.count()
        self.local = threading.local()      # each thread's open spans

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORD = _Record()


class _Span:
    """One live span: its name, its parent's name, its top span's id, host
    ``perf_counter_ns`` ends and, on a card, a pair of timing events."""

    __slots__ = ("name", "device", "parent", "top", "t0", "t1", "events",
                 "stream_ms", "_annotation")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.events, self.stream_ms = None, None

    def __enter__(self):
        stack = _RECORD.stack()
        if stack:
            self.parent, self.top = stack[-1].name, stack[-1].top
        else:
            self.parent, self.top = None, next(_RECORD.tops)
        stack.append(self)
        self._annotation = torch.profiler.record_function(PREFIX + self.name)
        self._annotation.__enter__()
        if self.device is not None and torch.device(self.device).type == \
                "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self._annotation.__exit__(*exc)
        self._annotation = None
        _RECORD.stack().pop()
        _RECORD.spans.append(self)
        return False

    def resolve(self) -> None:
        """Turn the events into ``stream_ms`` (waits for the second)."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.stream_ms = start.elapsed_time(end)
            self.events = None


def recording() -> bool:
    """Whether a profiler records on this thread (autograd's device
    threads inherit the state): spans and counts are live only then."""
    return torch.autograd._profiler_enabled()


def span(name: str, device=None):
    """A context manager around one layer's work, recorded only while a
    profiler records. ``device``: where the work runs; on a CUDA device
    the span also times the current stream. A span opened inside another
    on the same thread is its child and shares its top span's id (one id a
    frame or a training step); one opened on autograd's device thread, as
    a backward's is on a card, is a top of its own."""
    if not recording():
        return _OFF
    return _Span(name, device)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profiler records: a
    number as it comes, a tensor by reference, summed by :func:`read` (no
    operation runs and nothing waits here)."""
    if recording():
        values = _RECORD.counters.setdefault(name, [0])
        if isinstance(value, torch.Tensor):
            values.append(value)
        else:
            values[0] += value


def _total(values: list):
    """The sum of a counter's values; its tensors are reduced once and
    replaced by the sum, so the record keeps no device memory."""
    total = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            v = v.sum()
            v = float(v) if v.is_floating_point() else int(v)
        total += v
    values[:] = [total]
    return total


def read() -> dict:
    """The record so far: ``spans``, per name the number of closed spans
    and their total ``host_ms`` and ``stream_ms`` (None where none of them
    ran on a card); ``counters``, per name the total; and ``records``,
    every closed span in order of opening (name, parent, top id, host ms,
    stream ms). Waits for the card where a span's events are pending."""
    records, spans = [], {}
    for s in sorted(_RECORD.spans, key=lambda s: s.t0):
        s.resolve()
        host_ms = (s.t1 - s.t0) / 1e6
        records.append({"name": s.name, "parent": s.parent, "top": s.top,
                        "host_ms": host_ms, "stream_ms": s.stream_ms})
        tot = spans.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                        "stream_ms": None})
        tot["count"] += 1
        tot["host_ms"] += host_ms
        if s.stream_ms is not None:
            tot["stream_ms"] = (tot["stream_ms"] or 0.0) + s.stream_ms
    counters = {k: _total(v) for k, v in list(_RECORD.counters.items())}
    return {"spans": spans, "counters": counters, "records": records}


def clear() -> None:
    """Empty the record."""
    _RECORD.spans.clear()
    _RECORD.counters.clear()
