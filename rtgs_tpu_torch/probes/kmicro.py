"""Microbenchmarks of elementary operations at the peel kernels' launch
shape (port of ``scripts/kmicro.py``): each variant is one kernel of
``ops/csrc/probe_micro.cu``, one block per tile, computing a function
(T, P, C) f32 → (T, P, C) f32 with a plain torch version beside it.

    python -m rtgs_tpu_torch.probes.kmicro [--t 960] [--p 256] [--c 128]
        [--iters 5] [--variants a,b,...] [--device cuda]

The input is uniform in [0.1, 3.0), made from seed 0. One line per variant:
milliseconds (CUDA events, median of ``--iters``), GB/s of the block read
once and written once, elements per second, microseconds per tile.

The TPU variants and the port's. Several TPU variants differ only in a TPU
mechanism (a static against a dynamic slice, loop carry against scratch
memory, an argmin merge against a lane-rotation bitonic merge). The port
has one result for each such group, under the mechanisms that mean
something on Hopper: state in registers (``_reg``) against state in shared
memory (``_smem``), a top-K merge by register insertion (``_reg``) against
a warp-shuffle bitonic network (``_shfl``), a block-wide
``__syncthreads_or`` predicate (``any_when``, ``loop13_anywhen``,
``loop13_full``, ``_smem``) against none. The merge loops and the chunk
body write their whole state, 96 lanes (t1, ord, four payloads), where the
TPU loop-carry variants write 32 of them (t1 to lanes 0:16, the first
payload to 16:32, which is lanes 32:48 here).

    TPU variant      -> port variant(s)
    copy             -> copy
    mult             -> mult
    chain10          -> chain10
    div              -> div
    sqrt             -> sqrt
    exp              -> exp
    exp2             -> exp2
    exp_where        -> exp_where
    min_reduce       -> min_reduce
    min_reduce_sub   -> min_reduce_sub
    any_when         -> any_when
    any_when8        -> any_when8
    fori16           -> fori16
    fori128_tiny     -> fori128_tiny
    dynslice_sub     -> dynslice_sub
    argmin_pass      -> argmin_pass
    matvec_ones      -> matvec_ones
    roll_sub16       -> roll_sub16
    loop13_static    -> loop13_static
    loop13_dynslice  -> loop13_dynslice
    concat144        -> concat144
    merge16          -> merge16
    merge16_loop     -> merge16_loop_reg, merge16_loop_shfl
    bitonic16_loop   -> merge16_loop_shfl, merge16_loop_reg
    loop13_anywhen   -> loop13_anywhen, loop13_anywhen_reg
    loop13_full      -> loop13_full
    bitonic16_scr    -> merge16_loop_smem
    chunkbody        -> chunkbody
    body_carry_bit   -> chunkbody
    body_carry_arg   -> chunkbody

``matvec_ones`` is a row sum on the TPU's matrix unit; here it is a warp
reduction. ``roll_sub16`` (16 rotate-and-select steps along the pixel axis)
is the cyclic running minimum over 17 rows. ``chunkbody`` runs the port's
own sweep (``sweep_topk`` of ``peel_common.cuh``: the f32 screen, the
float64 entry depth of its survivors, register insertion) and shades the
winners in the log domain, on feature rows, candidate lists and pixel
features cut from the block as the TPU body cuts them; the three TPU chunk bodies differ in where the state lives
and in a predicate that the TPU probe forces true.
"""

from __future__ import annotations

import argparse
import math

import torch

from rtgs_tpu_torch.ops._launch import Launcher, check_tensors
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, G_DIM, _select,
                                     _shade_layers, _winner_rows)
from rtgs_tpu_torch.probes import _common

K = 16        # list capacity of the merge variants
LOOPS = 13    # chunk-loop trip count of the TPU probes

# The kernels' enum (ops/csrc/probe_micro.cu), in order.
VARIANTS = (
    "copy", "mult", "chain10", "div", "sqrt", "exp", "exp2", "exp_where",
    "min_reduce", "min_reduce_sub", "any_when", "any_when8", "fori16",
    "fori128_tiny", "dynslice_sub", "argmin_pass", "matvec_ones",
    "roll_sub16", "loop13_static", "loop13_dynslice", "loop13_anywhen",
    "loop13_full", "loop13_anywhen_reg", "concat144", "merge16",
    "merge16_loop_reg", "merge16_loop_shfl", "merge16_loop_smem",
    "chunkbody")

# Smallest (P, C) each variant reads; C must equal 128 where exact is set.
_NEEDS = {
    "fori128_tiny": (8, 1, False), "matvec_ones": (1, 8, False),
    "loop13_static": (32, 1, False), "loop13_dynslice": (224, 1, False),
    "loop13_anywhen": (8, 1, False), "loop13_anywhen_reg": (8, 1, False),
    "loop13_full": (200, 1, False), "concat144": (1, 16, False),
    "merge16": (1, 32, False), "merge16_loop_reg": (1, CHUNK, True),
    "merge16_loop_shfl": (1, CHUNK, True),
    "merge16_loop_smem": (1, CHUNK, True), "chunkbody": (192, CHUNK, True),
}


def _check_shape(name: str, x: torch.Tensor) -> None:
    if name not in VARIANTS:
        raise ValueError(f"unknown kmicro variant {name!r}")
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"kmicro {name}: x must be (T, P, C) f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    min_p, min_c, exact = _NEEDS.get(name, (1, 1, False))
    p, c = x.shape[1], x.shape[2]
    if p < min_p or c < min_c or (exact and c != min_c):
        raise ValueError(
            f"kmicro {name}: needs P >= {min_p} and C "
            f"{'==' if exact else '>='} {min_c}, got P={p}, C={c}")


def chunkbody_inputs(x: torch.Tensor):
    """The chunk body's tables, cut from the block as the TPU body cuts
    them: feature rows ``x[t, p, 0:64]`` (one table (T·P + 1, 64) with a
    sentinel row), per tile 13 chunks of 128 candidates, chunk c the rows
    from (c % 2)·64, and pixel features ``x[t, p, 0:24]``."""
    t, p, _ = x.shape
    sentinel = torch.zeros((1, F_DIM), dtype=x.dtype, device=x.device)
    sentinel[0, 9] = 1e30
    packed = torch.cat([x[:, :, :F_DIM].reshape(t * p, F_DIM), sentinel])
    i = torch.arange(CHUNK, device=x.device)
    off = (torch.arange(LOOPS, device=x.device) % 2) * 64
    rows = (off[:, None] + i[None, :]).reshape(-1)          # (13·128,)
    cand = (torch.arange(t, device=x.device)[:, None] * p
            + rows[None, :]).to(torch.int32)
    pix = x[:, :, :G_DIM].contiguous()
    return packed.contiguous(), cand.contiguous(), pix


def _sorted_state(t1, depth=K):
    """The K smallest of ``t1`` (T, P, M) by (t1, position): values and
    positions, vacant layers (+inf, −1)."""
    t1_s, order = torch.sort(t1, dim=-1, stable=True)
    t1_k, order = t1_s[..., :depth], order[..., :depth]
    return t1_k, torch.where(torch.isfinite(t1_k), order, -1)


def _with_state(x, state):
    out = x * 1.0001
    out[..., :state.shape[-1]] = state
    return out


def _merge_loop(x):
    """13 merges of a 16-entry state with the chunk ``x·(1+c)``, payload j
    ``x·(1+j+c)``: the 16 smallest of the 13·128 candidates by (t1, global
    slot c·128 + lane), dumped as (t1, ord, payload 1..4)."""
    cs = torch.arange(LOOPS, device=x.device, dtype=x.dtype)
    t1 = (x[..., None, :] * (1.0 + cs)[:, None]).flatten(-2)  # (T, P, 13·C)
    t1_k, slot = _sorted_state(t1)
    hit = slot >= 0
    c = torch.where(hit, slot // CHUNK, 0).to(x.dtype)
    v = torch.where(hit, x.gather(-1, slot.clamp(min=0) % CHUNK), 0.0)
    ord_k = torch.where(hit, slot.to(x.dtype), math.inf)
    pays = [torch.where(hit, v * (1.0 + j + c), 0.0) for j in range(1, 5)]
    return _with_state(x, torch.cat([t1_k, ord_k, *pays], dim=-1))


def _chunkbody(x):
    packed, cand, pix = chunkbody_inputs(x)
    t1, slots = _select(packed, cand, pix, K)               # (T, K, P)
    won = slots >= 0
    rows = _winner_rows(packed, cand, slots)
    a, b, _rho, _alpha, rgb = _shade_layers(rows, pix, won)
    cq, op = rows[..., 9], rows[..., 10]
    delta = b * b - (4.0 * a) * cq
    live = won & (delta > 0.0)
    qa = torch.where(
        live, b * b / (4.0 * a) - (cq + 3.0)
        + torch.log(torch.where(live, op, 1.0)), -math.inf)
    zero = torch.zeros_like(qa)
    state = torch.cat([
        t1, torch.where(won, slots.to(x.dtype), math.inf), qa,
        *(torch.where(won, ch, zero) for ch in rgb)], dim=1)  # (T, 6K, P)
    return _with_state(x, state.transpose(1, 2))


def _loop13(x, rows, off, scale_by_c):
    acc = torch.zeros_like(x[:, :rows])
    for c in range(LOOPS):
        v = x[:, c * off:c * off + rows]
        acc = torch.maximum(acc, v * (1.0 + c)) if scale_by_c \
            else acc + v * 1.0001
    out = x.clone()
    out[:, :rows] = acc
    return out


def _any_when8(x):
    # Eight predicated blocks per tile; the last one that fires wins.
    fired = torch.stack([(x < 0.1 * i).flatten(1).any(1)
                         for i in range(8)], dim=1)             # (T, 8)
    idx = torch.arange(8, device=x.device)
    last = torch.where(fired, idx, -1).amax(dim=1)              # (T,)
    f = torch.where(last >= 0, 1.0 + last.to(x.dtype), 1.0)
    return x * f[:, None, None]


def _argmin_pass(x):
    m = x.amin(dim=-1)                                          # (T, P)
    acc, w = torch.zeros_like(m), m
    for _ in range(6):
        acc = acc + w
        w = w * 1.0001
    out = x.clone()
    out[..., 0] = torch.where(torch.isfinite(m), acc, 0.0)
    return out


def _set_cols(x, lo, hi, val, scale=1.0):
    out = x * scale if scale != 1.0 else x.clone()
    out[..., lo:hi] = val
    return out


def _chain(x, n):
    for _ in range(n):
        x = x * 1.0001 + 1e-9
    return x


def _pow_rows(x, rows, n):
    out = x.clone()
    r = x[:, :rows]
    for _ in range(n):
        r = r * 1.0001
    out[:, :rows] = r
    return out


def _dynslice_sub(x):
    p = x.shape[1]
    acc = torch.zeros_like(x[:, 0])
    for i in range(128):
        acc = acc + x[:, i % p]
    out = x.clone()
    out[:, 0] = acc
    return out


def _roll_sub16(x):
    v = x
    for _ in range(16):
        v = torch.minimum(v, torch.roll(v, 1, dims=1))
    return v


def _merge16(x):
    t1_k, _ = _sorted_state(torch.cat([x[..., :K], x], dim=-1))
    return _with_state(x, torch.cat([t1_k, t1_k * 2.0], dim=-1))


_PLAIN = {
    "copy": lambda x: x.clone(),
    "mult": lambda x: x * 1.0001,
    "chain10": lambda x: _chain(x, 10),
    "div": lambda x: 1.0 / x,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "exp_where": lambda x: torch.where(x > 1.0, torch.exp(x), 0.0),
    "min_reduce": lambda x: x.amin(-1, keepdim=True).expand_as(x).clone(),
    "min_reduce_sub": lambda x: x.amin(-2, keepdim=True).expand_as(x).clone(),
    "any_when": lambda x: x * torch.where(
        (x < 0.5).flatten(1).any(1), 2.0, 1.0)[:, None, None],
    "any_when8": _any_when8,
    "fori16": lambda x: _chain(x, 16),
    "fori128_tiny": lambda x: _pow_rows(x, 8, 128),
    "dynslice_sub": _dynslice_sub,
    "argmin_pass": _argmin_pass,
    "matvec_ones": lambda x: _set_cols(x, 0, 8, x.sum(-1, keepdim=True)),
    "roll_sub16": _roll_sub16,
    "loop13_static": lambda x: _loop13(x, 32, 0, False),
    "loop13_dynslice": lambda x: _loop13(x, 32, 16, False),
    "loop13_anywhen": lambda x: _loop13(x, 8, 0, True),
    "loop13_anywhen_reg": lambda x: _loop13(x, 8, 0, True),
    "loop13_full": lambda x: _loop13(x, 8, 16, True),
    "concat144": lambda x: _set_cols(x, 0, 1, x.amin(-1, keepdim=True),
                                     scale=1.0001),
    "merge16": _merge16,
    "merge16_loop_reg": _merge_loop,
    "merge16_loop_shfl": _merge_loop,
    "merge16_loop_smem": _merge_loop,
    "chunkbody": _chunkbody,
}


def micro_torch(name: str, x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of variant ``name`` on ``x`` (T, P, C)."""
    _check_shape(name, x)
    return _PLAIN[name](x)


_MICRO = Launcher("rtgs_probe_micro", "kmicro")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(name: str, x: torch.Tensor, packed=None, cand=None, pix=None):
    dev = check_tensors(f"kmicro {name}", (("x", x, torch.float32, None),))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    t, p, c = x.shape
    _MICRO(dev, VARIANTS.index(name), x.data_ptr(), out.data_ptr(), t, p, c,
           _ptr(packed), _ptr(cand), _ptr(pix))
    micro_cuda.launches += 1
    return out


def chunkbody_cuda(x: torch.Tensor, packed, cand, pix) -> torch.Tensor:
    """Launch the ``chunkbody`` kernel on tables that
    :func:`chunkbody_inputs` made of ``x`` (a timing loop makes them once).
    Raises on a wrong input or a failed launch; counted in
    ``micro_cuda.launches``."""
    _check_shape("chunkbody", x)
    check_tensors("kmicro chunkbody", [
        ("x", x, torch.float32, None),
        ("packed", packed, torch.float32,
         (x.shape[0] * x.shape[1] + 1, F_DIM)),
        ("cand", cand, torch.int32, (x.shape[0], LOOPS * CHUNK)),
        ("pix", pix, torch.float32, (x.shape[0], x.shape[1], G_DIM))])
    return _launch("chunkbody", x, packed, cand, pix)


def micro_cuda(name: str, x: torch.Tensor) -> torch.Tensor:
    """Launch variant ``name`` of ``probe_micro.cu`` on the current stream.
    ``x``: contiguous (T, P, C) f32 CUDA tensor. Raises on a wrong input or
    a failed launch; ``micro_cuda.launches`` counts the launches."""
    _check_shape(name, x)
    if name == "chunkbody":
        check_tensors("kmicro chunkbody", (("x", x, torch.float32, None),))
        return chunkbody_cuda(x, *chunkbody_inputs(x))
    return _launch(name, x)


micro_cuda.launches = 0


def micro(name: str, x: torch.Tensor) -> torch.Tensor:
    """Variant ``name`` on ``x``: the kernel for a CUDA tensor (or an
    error), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return micro_torch(name, x)
    return micro_cuda(name, x)


def timed_call(name: str, x: torch.Tensor):
    """A function of no arguments that runs variant ``name`` on ``x`` and
    nothing else: the chunk body's tables are made here, once."""
    if x.device.type == "cpu":
        return lambda: micro_torch(name, x)
    if name == "chunkbody":
        tables = chunkbody_inputs(x)
        return lambda: chunkbody_cuda(x, *tables)
    return lambda: micro_cuda(name, x)


def make_input(t: int, p: int, c: int, device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((t, p, c), generator=gen) * 2.9 + 0.1
    return x.to(device).contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=960)
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--c", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--variants", type=str, default=",".join(VARIANTS))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    t, p, c = args.t, args.p, args.c
    x = make_input(t, p, c, dev)
    n = t * p * c
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"# device={kind} t={t} p={p} c={c} "
          f"bytes={2 * n * 4 / 1e6:.0f}MB per call", flush=True)
    for name in args.variants.split(","):
        fn = timed_call(name, x)

        ms, _ = _common.median_ms(fn, args.iters, dev)
        dt = ms / 1e3
        print(f"{name:18s}: {ms:8.3f} ms  {2 * n * 4 / dt / 1e9:7.1f} GB/s "
              f" {n / dt / 1e9:7.2f} Gelem/s  {dt / t * 1e6:6.2f} us/tile",
              flush=True)


if __name__ == "__main__":
    main()
