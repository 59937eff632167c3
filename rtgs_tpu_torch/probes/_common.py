"""What the probes share: the bench scene and its tile tables, and the
timers."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from rtgs_tpu_torch.ops.peel import CHUNK


def device_of(name: str) -> torch.device:
    """The probe's device; ``cuda`` without a card raises (no CPU
    fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass "
                           "--device cpu for the plain versions")
    return dev


def scene_tables(n: int, w: int, h: int, cand: int, glob: int,
                 narrow: int | None, device: torch.device):
    """The bench scene (``random_scene`` seed 0, extent 2.0, scales
    0.005-0.03) seen from the bench pose (θ 0.4, φ 1.2, r 5, FOV 60°),
    binned into 16×16 tiles. Returns (packed (N+1, 64), candidates (T, C)
    padded with −1 to a multiple of ``CHUNK``, chunk_lb, pix (T, 256, 24),
    binning)."""
    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features)
    from rtgs_tpu_torch.scene import random_scene
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    with torch.no_grad():
        g = random_scene(n, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                         device=device)
        pos, rot, _, _ = orbit_camera_pose(
            0.4, 1.2, 5.0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
        cam = camera_from_fov(pos, rot, (w, h), 60.0, device=device)
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
