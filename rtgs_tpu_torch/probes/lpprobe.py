"""The keys kernel in its forms, and the floor of its launch shape (port of
``scripts/lpprobe.py``).

    python -m rtgs_tpu_torch.probes.lpprobe [n] [w] [h] [--depth 16]
        [--cand 1536] [--glob 128] [--narrow 3] [--iters 7] [--device cuda]

(a) The TPU probe times its keys kernel over two axes, lane layout pk|lp ×
merge fori|unroll. Both are one kernel on Hopper (``ops/csrc/keys.cu``:
the list is in registers and the merge is an unrolled insertion), so this
probe times :func:`~rtgs_tpu_torch.ops.peel.peel_keys_cuda` in its output
layouts — (T, K, P) as the kernel writes it, and (T, P, K) made contiguous
for a pixel-major consumer — each with the early exit (``chunk_lb``) and
without it (zeros), and checks that all four agree bitwise.

(b) The floor kernels (``ops/csrc/probe_floor.cu``), output (T, 2K, P) f32
as the kernel's (t1, id) pair: ``nothing`` writes +inf; ``touch`` writes,
per tile, the sum over the tile's candidate rows of feature lane 0 (a −1
slot reads the sentinel row N). Each at T, T/4 and T/16 tiles, to separate
the per-tile cost from the launch.

(c) On the card, where a wrapper call's host time goes: the host clock
around ``HOST_ROUNDS`` rounds of ``HOST_CALLS`` calls (the stream drained
between rounds, the median round) of ``floor_cuda("nothing", ...)`` and of
``peel_keys_cuda``, of each step of the launch path (``ops/_launch.py``:
the checks, the outputs' allocation, the stream handle, the C call with its
arguments ready), and beside them the same steps as the wrappers took them before the
shared launch helper (messages formatted before they are needed, the
library looked up through an import and a cache on every call, every
argument boxed as a ``ctypes`` object, a ``Stream`` object built for its
handle), and ``torch.full``'s host time as the yardstick.

One line per measurement: label, milliseconds (CUDA events, median of
``--iters``), the minimum.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import time

import torch

from rtgs_tpu_torch.ops._launch import Launcher, check_tensors
from rtgs_tpu_torch.ops.peel import F_DIM, _counts, _safe_ids, peel_keys
from rtgs_tpu_torch.probes import _common

FLOOR_VARIANTS = ("nothing", "touch")


def floor_torch(name: str, packed, candidates, p: int, depth: int):
    """The plain torch version of floor variant ``name``: (T, 2K, P)."""
    if name not in FLOOR_VARIANTS:
        raise ValueError(f"unknown floor variant {name!r}")
    t = candidates.shape[0]
    if name == "nothing":
        return torch.full((t, 2 * depth, p), math.inf, dtype=torch.float32,
                          device=packed.device)
    s = packed[:, 0][_safe_ids(packed, candidates)].sum(dim=1)   # (T,)
    return s[:, None, None].expand(t, 2 * depth, p).contiguous()


_FLOOR = Launcher("rtgs_probe_floor", "lpprobe floor")


def floor_cuda(name: str, packed, candidates, p: int, depth: int):
    """Launch floor variant ``name`` of ``probe_floor.cu`` on the current
    stream. packed (N+1, 64) f32 and candidates (T, C) i32, contiguous CUDA
    tensors. Raises on a wrong input or a failed launch;
    ``floor_cuda.launches`` counts the launches."""
    if name not in FLOOR_VARIANTS:
        raise ValueError(f"unknown floor variant {name!r}")
    t, c = candidates.shape
    dev = check_tensors(f"lpprobe {name}", [
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c))])
    if p < 1 or depth < 1:
        raise ValueError(f"lpprobe {name}: P={p} and depth={depth} must be "
                         "positive")
    out = torch.empty((t, 2 * depth, p), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    _FLOOR(dev, FLOOR_VARIANTS.index(name), packed.data_ptr(),
           candidates.data_ptr(), out.data_ptr(), t, c, p, 2 * depth,
           packed.shape[0] - 1)
    floor_cuda.launches += 1
    return out


floor_cuda.launches = 0


def floor(name: str, packed, candidates, p: int, depth: int):
    """Floor variant ``name``: the kernel for CUDA tensors (or an error),
    the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return floor_torch(name, packed, candidates, p, depth)
    return floor_cuda(name, packed, candidates, p, depth)


def keys_forms(packed, candidates, chunk_lb, pix, depth: int):
    """The keys stage in its four forms, label → a function returning
    (t1, sid): layouts ``kp`` (T, K, P) and ``pk`` (T, P, K), each with
    ``chunk_lb`` and with the early exit disabled. On CPU tensors
    :func:`~rtgs_tpu_torch.ops.peel.peel_keys` runs the plain twin, which
    ignores ``chunk_lb``."""
    def run(lb, layout):
        t1, sid = peel_keys(packed, candidates, pix, depth, chunk_lb=lb)
        if layout == "pk":
            return (t1.transpose(1, 2).contiguous(),
                    sid.transpose(1, 2).contiguous())
        return t1, sid

    return {f"{layout} lb={'on' if lb is not None else 'off'}":
            (lambda lb=lb, layout=layout: run(lb, layout))
            for layout in ("kp", "pk") for lb in (chunk_lb, None)}


def forms_agree(outs: dict) -> dict:
    """Whether each form's (t1, sid) equals the first form's bitwise, read
    in the (T, K, P) layout."""
    def kp(tag, o):
        return [x.transpose(1, 2) if tag.startswith("pk") else x for x in o]

    tags = list(outs)
    ref = kp(tags[0], outs[tags[0]])
    return {tag: all(torch.equal(a, b)
                     for a, b in zip(ref, kp(tag, outs[tag])))
            for tag in tags}


HOST_ROUNDS, HOST_CALLS = 10, 100


def host_us(fn, device) -> float:
    """Host microseconds a call of ``fn()``: the host clock around
    ``HOST_CALLS`` calls with no synchronisation inside, the stream drained
    before and after each round; the median of ``HOST_ROUNDS`` rounds after
    one warm-up call."""
    fn()
    per_call = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize(device)
    return statistics.median(per_call)


def _eager_checks(who, specs):
    """The wrappers' checks as they stood before ``check_tensors``: every
    message formatted whether or not its condition fails."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{who}: {msg}")

    dev = specs[0][1].device
    require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    for name, x, dtype, shape in specs:
        require(x.device == dev, f"{name} is on {x.device}, not {dev}")
        require(x.dtype == dtype, f"{name} is {x.dtype}, want {dtype}")
        require(tuple(x.shape) == tuple(shape),
                f"{name} has shape {tuple(x.shape)}, want {tuple(shape)}")
        require(x.is_contiguous(), f"{name} is not contiguous")
    return dev


def host_table(packed, cand, lb, pix, depth: int):
    """Rows (label, host µs a call) of (c) in the module's docstring."""
    from rtgs_tpu_torch.ops import _build, _launch, peel

    dev = packed.device
    t, c = cand.shape
    p = pix.shape[1]
    counts = _counts(cand)
    idx = dev.index
    lib = _build.load_library()
    rows = []

    def row(label, fn):
        rows.append((label, host_us(fn, dev)))

    def boxed_stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def lookup():
        from rtgs_tpu_torch.ops import _build as again

        return again.load_library()

    # The floor kernel `nothing`.
    f_specs = lambda: [  # noqa: E731
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", cand, torch.int32, (t, c))]
    out = torch.empty((t, 2 * depth, p), dtype=torch.float32, device=dev)
    f_args = (0, packed.data_ptr(), cand.data_ptr(), out.data_ptr(), t, c, p,
              2 * depth, packed.shape[0] - 1)
    vp = ctypes.c_void_p
    row("nothing: the whole wrapper call",
        lambda: floor_cuda("nothing", packed, cand, p, depth))
    row("nothing: checks", lambda: check_tensors("lpprobe", f_specs()))
    row("nothing: checks, messages formatted eagerly (before)",
        lambda: _eager_checks("lpprobe", f_specs()))
    row("nothing: output allocation (torch.empty)",
        lambda: torch.empty((t, 2 * depth, p), dtype=torch.float32,
                            device=dev))
    row("stream handle as an int", lambda: _launch._raw_stream(idx))
    row("stream handle through a Stream object, boxed (before)",
        boxed_stream)
    row("library through an import and a cached call (before)", lookup)
    row("nothing: C call, plain ints",
        lambda: _FLOOR.fn(*f_args, idx, _launch._raw_stream(idx)))
    row("nothing: C call, arguments boxed one by one (before)",
        lambda: lib.rtgs_probe_floor(
            0, vp(packed.data_ptr()), vp(cand.data_ptr()),
            vp(out.data_ptr()), t, c, p, 2 * depth, packed.shape[0] - 1, idx,
            boxed_stream()))
    shape = (t, 2 * depth, p)
    row("torch.full of the same output",
        lambda: torch.full(shape, math.inf, device=dev))

    # The keys kernel.
    k_specs = lambda: [  # noqa: E731
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", cand, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("chunk_lb", lb, torch.float32, (t, c // peel.CHUNK + 1)),
        ("pix", pix, torch.float32, (t, p, peel.G_DIM))]
    t1 = torch.empty((t, depth, p), dtype=torch.float32, device=dev)
    sid = torch.empty((t, depth, p), dtype=torch.int32, device=dev)
    ptrs = (packed.data_ptr(), cand.data_ptr(), counts.data_ptr(),
            lb.data_ptr(), pix.data_ptr(), None, None,   # no floor
            t1.data_ptr(), sid.data_ptr())
    row("keys: the whole wrapper call",
        lambda: peel.peel_keys_cuda(packed, cand, counts, lb, pix, depth))
    row("keys: checks",
        lambda: peel._check_launch("keys", k_specs(), c, p, depth))
    row("keys: checks, messages formatted eagerly (before)",
        lambda: _eager_checks("keys", k_specs()))
    row("keys: output allocation (one torch.empty, two views)",
        lambda: torch.empty((2, t, depth, p), dtype=torch.float32,
                            device=dev)[1].view(torch.int32))
    row("keys: output allocation, 2 x torch.empty (before)",
        lambda: (torch.empty((t, depth, p), dtype=torch.float32, device=dev),
                 torch.empty((t, depth, p), dtype=torch.int32, device=dev)))
    row("keys: C call, plain ints",
        lambda: peel._KEYS.fn(*ptrs, None, t, c, p, depth, idx,
                              _launch._raw_stream(idx)))
    row("keys: C call, arguments boxed one by one (before)",
        lambda: lib.rtgs_keys_sid(*(vp(x) for x in ptrs), vp(0), t, c, p,
                                  depth, idx, boxed_stream()))
    row("keys: _counts(candidates), which peel_keys adds without counts",
        lambda: _counts(cand))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("w", type=int, nargs="?", default=640)
    ap.add_argument("h", type=int, nargs="?", default=384)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--glob", type=int, default=128)
    ap.add_argument("--narrow", type=int, default=3)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    packed, cand, lb, pix, _ = _common.scene_tables(
        args.n, args.w, args.h, args.cand, args.glob, args.narrow, dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"# device={kind} tiles={cand.shape[0]} cand={cand.shape[1]} "
          f"mean_count={float(_counts(cand).float().mean()):.0f}",
          flush=True)

    def line(label, fn):
        ms, lo = _common.median_ms(fn, args.iters, dev)
        print(f"{label:24s} {ms:8.3f} ms   (min {lo:.3f})", flush=True)

    forms = keys_forms(packed, cand, lb, pix, args.depth)
    outs = {}
    for tag, fn in forms.items():
        line(tag, fn)
        outs[tag] = fn()
    first = next(iter(outs))
    for tag, same in forms_agree(outs).items():
        print(f"  {tag}: bitwise == {first}: {same}", flush=True)
        if not same:
            raise RuntimeError(f"keys form {tag!r} differs from {first!r}")

    t, p = cand.shape[0], pix.shape[1]
    for tsub in (t, t // 4, t // 16):
        sub = cand[:tsub].contiguous()
        for name in FLOOR_VARIANTS:
            line(f"floor {name} t={tsub}",
                 lambda: floor(name, packed, sub, p, args.depth))

    if dev.type == "cuda":
        for label, us in host_table(packed, cand, lb, pix, args.depth):
            print(f"host {label:62s} {us:8.2f} us", flush=True)


if __name__ == "__main__":
    main()
