"""What the probes share: the bench configurations, scene and pose, the
bench scene's tile tables, and the timers."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from rtgs_tpu_torch.ops.peel import CHUNK

# The benchmark configurations of the JAX package (bench.py CONFIGS with its
# RENDER_KW: 16x16 tiles, max_global 128), each with its tile bands.
BENCH_CONFIGS = (
    dict(label="100k@640x384", n=100_000, res=(640, 384),
         max_candidates=1536, bin_narrow=3, tile_bands=None),
    dict(label="250k@1280x720", n=250_000, res=(1280, 720),
         max_candidates=1536, bin_narrow=3, tile_bands=None),
    dict(label="1M@1920x1088", n=1_000_000, res=(1920, 1088),
         max_candidates=3584, bin_narrow=4, tile_bands=8),
)
BENCH_MAX_GLOBAL = 128
# The bench scene (random_scene: splats in a cube of half-size 2) and pose
# (orbit θ 0.4, φ 1.2, r 5, 60° vertical FOV).
BENCH_SCENE = dict(extent=2.0, scale_range=(0.005, 0.03), seed=0)
BENCH_POSE = dict(theta=0.4, phi=1.2, r=5.0, fov=60.0)


def device_of(name: str) -> torch.device:
    """The probe's device; ``cuda`` without a card raises (no CPU
    fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass "
                           "--device cpu for the plain versions")
    return dev


def bench_camera(res, device, theta=BENCH_POSE["theta"],
                 phi=BENCH_POSE["phi"], r=BENCH_POSE["r"],
                 fov=BENCH_POSE["fov"]):
    """The camera of the bench pose (or another orbit pose) at ``res``."""
    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    pos, rot, _, _ = orbit_camera_pose(
        theta, phi, r, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, fov, device=device)


def sync(device: torch.device) -> None:
    """Wait for ``device`` where it is a card (host clocks around a call)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_gib(device: torch.device):
    """Peak device memory since the last reset, in GiB; None off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def scene_tables(n: int, w: int, h: int, cand: int, glob: int,
                 narrow: int | None, device: torch.device):
    """The bench scene (``random_scene`` seed 0, extent 2.0, scales
    0.005-0.03) seen from the bench pose (θ 0.4, φ 1.2, r 5, FOV 60°),
    binned into 16×16 tiles. Returns (packed (N+1, 64), candidates (T, C)
    padded with −1 to a multiple of ``CHUNK``, chunk_lb, pix (T, 256, 24),
    binning)."""
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features)
    from rtgs_tpu_torch.scene import random_scene

    with torch.no_grad():
        g = random_scene(n, device=device, **BENCH_SCENE)
        cam = bench_camera((w, h), device)
        packed = pack_features(precompute_features(g, cam))
        binning = tile_candidates(
            g, cam, tile=(16, 16), max_candidates=cand, max_global=glob,
            narrow=narrow, chunk=CHUNK,
            entry_lb=entry_lower_bound(g, cam, packed))
        cands = binning.candidates
        pad_c = (-cands.shape[1]) % CHUNK
        if pad_c:
            cands = F.pad(cands, (0, pad_c), value=-1)
        pix = _tile_pixel_features(cam, (16, 16))
    return (packed.contiguous(), cands.contiguous(),
            binning.chunk_lb.contiguous(), pix.contiguous(), binning)


def median_ms(fn, iters: int, device: torch.device):
    """Median and minimum milliseconds of ``fn()`` over ``iters`` calls
    after one warm-up: CUDA events on the card, the host clock on the CPU
    (where the number times the plain version and is no device metric)."""
    fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2], ts[0]


def busy_ms(fn, iters: int, device: torch.device) -> float:
    """Median device milliseconds of ``fn()`` with the host's share taken
    out: the stream is first kept busy by a long kernel (an in-place pass
    over 1 GiB, twice), so the host enqueues the start event, ``fn``'s
    launches and the end event while the card still works on it, and the
    events then bracket ``fn``'s device work alone. Beside
    :func:`median_ms` it says how much of a wrapper's time is the host's
    (allocation, ctypes, launch). CUDA only."""
    ballast = torch.empty(2**28, dtype=torch.float32, device=device)
    fn()
    ts = []
    for _ in range(iters):
        torch.cuda.synchronize(device)
        ballast.mul_(1.0)
        ballast.mul_(1.0)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        ts.append(t0.elapsed_time(t1))
    ts.sort()
    return ts[len(ts) // 2]
