"""The traced run's instruments: spans around the port's layer entry points,
the launches of its kernels, and the profiler's trace reduced to what the
per-layer readers read.

Spans wrap a module attribute (``"rtgs_tpu_torch.render.tiled:
tile_candidates"``) that the port looks up when it calls it, so the traced
path is the real one. A device operation belongs to every span open on the
launching thread when its launch was issued (matched by the profiler's
correlation ids), so nested spans each see their own kernels and those of
their children. A launch recorder also stores the shape of each call for
the roofline bounds; what it must count on the device it counts on a side
stream, inside a span of its own whose operations no metric reads.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import tempfile

import torch

PREFIX = "bench::"
COUNT = "count"                 # the side stream's span
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def resolve(target: str):
    """(module, attribute name) of ``"package.module:attr"``."""
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


def load_callable(target: str):
    mod, attr = resolve(target)
    return getattr(mod, attr)


class Tracer:
    """Spans and launch records for a set of wrapped attributes. ``spans``:
    the targets to wrap in a span; ``launches``: target → the bounds
    function that reads its calls' shapes. Wrappers are installed by
    :meth:`installed` and removed after it."""

    def __init__(self, spans, launches):
        self.spans = sorted(set(spans) | set(launches))
        self.launches = dict(launches)
        self.records: list[tuple[str, dict]] = []
        self._side = None

    def _side_eval(self, fn, *xs: torch.Tensor) -> torch.Tensor:
        """``fn(*xs)`` computed on the side stream, after what the timed
        stream has queued."""
        self._side.wait_stream(torch.cuda.current_stream(xs[0].device))
        with torch.profiler.record_function(PREFIX + COUNT), \
                torch.cuda.stream(self._side):
            for x in xs:
                x.record_stream(self._side)
            return fn(*xs)

    def _wrap(self, target: str, orig):
        label = PREFIX + target
        reader = self.launches.get(target)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                out = orig(*args, **kwargs)
            if reader is not None:
                self.records.append((target, reader(args, kwargs, out,
                                                    self._side_eval)))
            return out

        return wrapper

    @contextlib.contextmanager
    def installed(self, device):
        """The wrappers in place for the block; the side stream is made
        here, outside any traced stretch."""
        if self.launches:
            self._side = torch.cuda.Stream(device=device)
        saved = []
        try:
            for target in self.spans:
                mod, attr = resolve(target)
                orig = getattr(mod, attr)
                saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(target, orig))
            yield self
        finally:
            for mod, attr, orig in reversed(saved):
                # A wrapped launcher counts its calls on the wrapper
                # (``fn.launches += 1`` reads the module's name).
                if hasattr(getattr(mod, attr), "launches"):
                    orig.launches = getattr(mod, attr).launches
                setattr(mod, attr, orig)

    def resolved_records(self):
        """The launch records with their device counts as integers (call
        once the traced stretch has ended and the card is synchronised)."""
        return [(t, {k: int(v) if isinstance(v, torch.Tensor) else v
                     for k, v in shape.items()})
                for t, shape in self.records]


def profile(fn, device, host: bool) -> "Trace":
    """Run ``fn()`` under ``torch.profiler`` between two synchronisations;
    export the Chrome trace to the temporary directory, read it and delete
    it. ``host``: record the host's operations and the bench spans too (CPU
    activity, whose per-operation cost slows a host-bound loop); without it
    only the card's activity and the runtime calls are recorded, and the
    window runs from the first runtime call to the end of the last."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize(device)
    with torch_profile(activities=acts) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            fn()
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


class Trace:
    """A Chrome trace reduced to: the window's interval, the device
    operations in it (each with the labels of the bench spans open at its
    launch) and the host events (for naming idle gaps)."""

    def __init__(self, events):
        spans, runtime, device, self.host = {}, [], [], []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "user_annotation" and name.startswith(PREFIX):
                label = name[len(PREFIX):]
                if label == "window":
                    self.window = (ts, ts + dur)
                else:
                    spans.setdefault(e.get("tid"), []).append(
                        (ts, ts + dur, label))
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    runtime.append((corr, e.get("tid"), ts))
            if cat in DEVICE_CATS:
                device.append(e)
            elif cat in HOST_CATS and name != PREFIX + "window":
                self.host.append((ts, ts + dur, e.get("tid"), name))
        if self.window is None:
            calls = [(ts, ts + float(e.get("dur", 0.0))) for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver")
                     for ts in [float(e.get("ts", 0.0))]]
            if not calls:
                raise RuntimeError("the trace holds no runtime call")
            self.window = (min(c[0] for c in calls), max(c[1] for c in calls))
        for lst in spans.values():
            lst.sort()
        owner = {}
        for corr, tid, ts in runtime:
            owner[corr] = _open_labels(spans.get(tid, ()), ts)
        lo, hi = self.window
        self.ops = []      # (start µs, end µs, name, cat, labels)
        for e in device:
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            if end < lo or ts > hi:
                continue
            corr = (e.get("args") or {}).get("correlation")
            self.ops.append((ts, end, e.get("name", ""), e.get("cat"),
                             owner.get(corr, frozenset())))
        self.ops.sort()
        # The program's operations: not the benchmark's own counting.
        self.program = [o for o in self.ops if COUNT not in o[4]]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, labels=None, kernels=None) -> float:
        """Device µs of the program's operations launched inside a span of
        one of ``labels`` (all if None) whose name holds one of the
        fragments ``kernels`` (all if None)."""
        return sum(e - s for s, e, name, _c, own in self.program
                   if (labels is None or own & labels)
                   and (kernels is None or any(k in name for k in kernels)))

    def spans_seen(self, labels) -> bool:
        return any(own & labels for *_x, own in self.program)

    def kernel_count(self) -> int:
        return sum(1 for o in self.program if o[3] == "kernel")

    def busy(self):
        """The union of the program's device intervals, clipped to the
        window: (busy µs, the idle gaps as (start, end))."""
        lo, hi = self.window
        busy, gaps, cur = 0.0, [], lo
        for s, e, *_x in self.program:
            s, e = max(s, lo), min(e, hi)
            if e <= cur:
                continue
            if s > cur:
                gaps.append((cur, s))
                cur = s
            busy += e - cur
            cur = e
        if hi > cur:
            gaps.append((cur, hi))
        return busy, gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        summed by the innermost host event open at each gap's middle."""
        by_op: dict[str, float] = {}
        for s, e, name, _c, _o in self.program:
            key = _short(name)
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        _busy, gaps = self.busy()
        host = sorted(self.host)
        by_host: dict[str, float] = {}
        active, j = [], 0
        for s, e in gaps:          # in time order, as busy() lists them
            mid = 0.5 * (s + e)
            while j < len(host) and host[j][0] <= mid:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] >= mid]
            best = min(active, key=lambda h: h[1] - h[0], default=None)
            key = "no host event" if best is None else _short(best[3])
            by_host[key] = by_host.get(key, 0.0) + (e - s)

        def ranked(d):
            return [[k, v * 1e-6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}


def _open_labels(spans, ts) -> frozenset:
    """Labels of the spans (start, end, label), sorted by start, that
    contain ``ts``."""
    i = bisect.bisect_right(spans, (ts, float("inf"), ""))
    return frozenset(lab for s, e, lab in spans[max(0, i - 64):i]
                     if s <= ts <= e)


def _short(name: str) -> str:
    """A kernel or op name without its parameter list, at most 96
    characters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:96]
