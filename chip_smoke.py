#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtgs_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Phases, one line
each (any failure exits non-zero, and nothing falls back to the CPU):

  1. device and toolchain: card name and power limit, torch, CUDA, nvcc;
  2. build the CUDA kernels from the sources in this checkout;
  3. the keys kernel against its plain torch twin at the main path's
     shapes — 100k splats at 640x384 and 1M splats at 256x192 — bitwise,
     with and without the early-exit bounds, timed with CUDA events; and a
     whole 256x192 frame through the kernel against one through the twin;
  4. precision of the kernel's winning t1 against float64 recomputed from
     the same f32 inputs;
  5. the main path through the CLI: ``render`` and a 3-frame ``orbit`` of a
     1M-splat scene at 1920x1088, depth 16, 8 tile bands; every frame must
     have launched the kernel once per band; the image is checked (finite,
     not black, dropped candidates < 0.1%) and its frame and per-stage
     times measured.

Then one {"kernels": [...]} JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEPTH = 16
TILE = (16, 16)
# Pose and scene of the repository's benchmark (bench.py): orbit θ 0.4,
# φ 1.2, r 5, 60° vertical FOV; splats in a cube of half-size 2.
POSE = dict(theta=0.4, phi=1.2, r=5.0, fov=60.0)
SCENE = dict(extent=2.0, scale_range=(0.005, 0.03), seed=0)
CFG_100K = dict(n=100_000, res=(640, 384), max_candidates=1536,
                max_global=128, bin_narrow=3)
CFG_1M_GATE = dict(n=1_000_000, res=(256, 192), max_candidates=3584,
                   max_global=128, bin_narrow=4)
FULL_RES = (1920, 1088)
BANDS = 8
ORBIT_FRAMES = 3
MAX_DROPPED = 1e-3
MAX_T1_REL_P999 = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``."""
    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"ILi(\d+)E", m.group(1))
            name = f"K={k.group(1)}" if k else m.group(1)
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
    return " | ".join(out)


def time_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def camera(res, dev):
    import numpy as np

    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    pos, rot, _, _ = orbit_camera_pose(
        POSE["theta"], POSE["phi"], POSE["r"], np.zeros(3),
        np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, POSE["fov"], device=dev)


def keys_inputs(g, cfg, dev):
    from rtgs_tpu_torch.ops.peel import CHUNK, _counts
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             pack_features,
                                             precompute_features)

    cam = camera(cfg["res"], dev)
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=cfg["max_candidates"],
                        max_global=cfg["max_global"],
                        narrow=cfg["bin_narrow"], chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, TILE)
    return cam, packed, b.candidates, _counts(b.candidates), b.chunk_lb, pix


def phase3_case(label, g, cfg, dev):
    """Kernel vs twin, bitwise, at one configuration; returns the timings
    and the kernel's outputs."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda, peel_keys_torch

    cam, packed, cand, counts, lb, pix = keys_inputs(g, cfg, dev)
    zeros = torch.zeros_like(lb)

    def kernel():
        return peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)

    def kernel_full():
        return peel_keys_cuda(packed, cand, counts, zeros, pix, DEPTH)

    def twin():
        return peel_keys_torch(packed, cand, pix, DEPTH)

    t1_k, sid_k = kernel()
    t1_f, sid_f = kernel_full()
    t1_t, sid_t = twin()
    torch.cuda.synchronize()
    fin = torch.isfinite(t1_t)
    err = float((t1_k - t1_t)[fin].abs().max()) if fin.any() else 0.0
    check(torch.equal(sid_k, sid_t),
          f"{label}: kernel ids differ from the twin at "
          f"{int((sid_k != sid_t).sum())} entries")
    check(torch.equal(t1_k, t1_t), f"{label}: kernel t1 differs from the "
          f"twin (max |diff| {err})")
    check(torch.equal(sid_f, sid_k) and torch.equal(t1_f, t1_k),
          f"{label}: early exit changed the result")
    check(bool((sid_k >= 0).any()), f"{label}: no pixel has a hit")
    ms = time_ms(kernel)
    ms_full = time_ms(kernel_full)
    ms_twin = time_ms(twin)
    t, c = cand.shape
    say(3, f"keys {label}: T={t} C={c} P={pix.shape[1]} K={DEPTH}: ids and "
           f"t1 bitwise equal to the twin, and with chunk_lb bitwise equal "
           f"to the full sweep; kernel {ms:.3f} ms (full sweep "
           f"{ms_full:.3f} ms), twin {ms_twin:.3f} ms (CUDA events, median "
           f"of 5)")
    return dict(ms=ms, ms_full=ms_full, ms_twin=ms_twin, max_abs_err=err,
                packed=packed, pix=pix, t1=t1_k, sid=sid_k, cam=cam)


def phase4_precision(case):
    """Relative error of the winners' t1 against float64 recomputed from
    the same f32 inputs; an f32 evaluation of the same chain is reported
    beside it."""
    import numpy as np
    import torch

    sid, t1 = case["sid"], case["t1"]
    hit = sid >= 0
    rows = case["packed"][:, :10][sid.clamp(min=0).long()]   # (T, K, P, 10)
    q = case["pix"][:, None, :, :9]                           # (T, 1, P, 9)

    def chain(rows, q):
        a = (q[..., 3:9] * rows[..., 0:6]).sum(-1)
        b = 2.0 * (q[..., 0:3] * rows[..., 6:9]).sum(-1)
        delta = b * b - 4.0 * a * rows[..., 9]
        return (-b - torch.sqrt(delta.clamp(min=0))) / (2.0 * a)

    t64 = chain(rows.double(), q.double())[hit]
    t32 = chain(rows, q)[hit].double()

    def rel(x):
        return ((x - t64).abs() / t64.abs()).cpu().numpy()

    r_kernel, r_f32 = rel(t1[hit].double()), rel(t32)
    med, p999 = np.median(r_kernel), np.quantile(r_kernel, 0.999)
    say(4, f"t1 of {int(hit.sum())} winners vs float64: median rel err "
           f"{med:.3e}, p99.9 {p999:.3e} (limit {MAX_T1_REL_P999:g}); an "
           f"f32 chain would give median {np.median(r_f32):.3e}, p99.9 "
           f"{np.quantile(r_f32, 0.999):.3e}")
    check(p999 <= MAX_T1_REL_P999, f"t1 p99.9 rel err {p999} > "
          f"{MAX_T1_REL_P999}")


def frame_parity(g, cfg, dev):
    """One frame through the kernel and one through the twin: the same
    selection feeds the same shading, so the images must be equal."""
    import torch

    from rtgs_tpu_torch.render.tiled import render_tiled_keys

    cam = camera(cfg["res"], dev)
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=cfg["max_candidates"],
              max_global=cfg["max_global"], bin_narrow=cfg["bin_narrow"])
    with torch.inference_mode():
        img_k = render_tiled_keys(g, cam, keys_impl="cuda", **kw)
        img_t = render_tiled_keys(g, cam, keys_impl="torch", **kw)
    diff = float((img_k - img_t).abs().max())
    check(bool(torch.isfinite(img_k).all()), "frame parity: non-finite")
    check(diff == 0.0, f"frame parity: max |kernel − twin| = {diff}")
    say(3, f"frame {cfg['res'][0]}x{cfg['res'][1]} of the 1M scene: kernel "
           f"path equals twin path (max |diff| {diff})")


def stage_times(g, cam, kw):
    """Per-stage device times of one banded frame (CUDA events), in ms."""
    import torch

    from rtgs_tpu_torch.ops.peel import CHUNK, peel_keys
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             composite_layers_kp,
                                             pack_features,
                                             precompute_features,
                                             shade_winners_kp)

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    marks = {"binning": [], "features": [], "keys": [], "shade": [],
             "composite": []}
    e0 = mark()
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"],
                        narrow=kw["bin_narrow"], chunk=CHUNK)
    e1 = mark()
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, TILE)
    e2 = mark()
    marks["binning"].append((e0, e1))
    marks["features"].append((e1, e2))
    t = b.candidates.shape[0]
    nb = -(-t // kw["tile_bands"])
    for s in range(0, t, nb):
        a = mark()
        _, sid = peel_keys(packed, b.candidates[s:s + nb], pix[s:s + nb],
                           DEPTH, chunk_lb=b.chunk_lb[s:s + nb])
        k = mark()
        layers = shade_winners_kp(packed, sid, pix[s:s + nb])
        sh = mark()
        composite_layers_kp(*layers)
        c = mark()
        marks["keys"].append((a, k))
        marks["shade"].append((k, sh))
        marks["composite"].append((sh, c))
    end = mark()
    end.synchronize()
    out = {name: sum(s.elapsed_time(e) for s, e in pairs)
           for name, pairs in marks.items()}
    out["total"] = e0.elapsed_time(end)
    return out


def phase5_main_path(g, dev, tmp):
    import numpy as np
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import save_scene

    ply = tmp / "scene_1m.ply"
    t0 = time.perf_counter()
    save_scene(ply, g)
    say(5, f"wrote the {g.num}-splat scene to a .ply in "
           f"{time.perf_counter() - t0:.1f} s")
    w, h = FULL_RES
    argv = ["-o", str(ply), "-r", f"{w},{h}", "-d", str(DEPTH),
            "--fov", str(POSE["fov"]), "--radius", str(POSE["r"]),
            "--theta", str(POSE["theta"]), "--phi", str(POSE["phi"]),
            "--max-candidates", "3584", "--tile-bands", str(BANDS),
            "--bin-narrow", "4", "--renderer", "keys", "--device", "cuda"]

    # The main path: one render and an orbit, through the CLI.
    peel_keys_cuda.launches = 0
    t0 = time.perf_counter()
    cli(["render", *argv, "--output", str(tmp / "frame.npy")])
    cli(["orbit", *argv, "--frames", str(ORBIT_FRAMES),
         "--output", str(tmp / "orbit")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = peel_keys_cuda.launches
    frames = 1 + ORBIT_FRAMES
    say(5, f"CLI render + orbit --frames {ORBIT_FRAMES}: {frames} frames in "
           f"{wall:.2f} s wall (scene loads included); keys kernel "
           f"launches {launches} (expected {BANDS} per frame = "
           f"{BANDS * frames})")
    check(launches == BANDS * frames, f"keys kernel launched {launches} "
          f"times, expected {BANDS * frames}")
    # PNG where imageio or PIL is installed, .npy otherwise.
    saved = [tmp / "frame.npy"] + sorted((tmp / "orbit").glob("frame_*"))
    check(len(saved) == frames and saved[0].is_file(),
          f"expected {frames} saved frames, found {[p.name for p in saved]}")
    for p in saved:
        if p.suffix == ".npy":
            img8 = np.load(p)
            check(img8.shape == (h, w, 3) and img8.max() > 0,
                  f"{p.name}: shape {img8.shape}, max {img8.max()}")

    # The same frame in process: values, binning counters and times.
    cam = camera(FULL_RES, g.device)
    kw = dict(max_candidates=3584, max_global=64, tile_bands=BANDS,
              bin_narrow=4)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        img, stats = render_tiled_keys(g, cam, depth=DEPTH, tile=TILE,
                                       with_stats=True, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(tuple(img.shape) == (w, h, 3), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "image has non-finite values")
        mean = float(img.mean())
        check(float(img.max()) > 0.05, "image is black")
        stats = {k: int(v) for k, v in stats.items()}
        dropped = stats["local_overflow"] + stats["global_overflow"]
        share = dropped / max(stats["live"] + dropped, 1)
        say(5, f"frame {w}x{h}: finite, mean {mean:.4f}, max "
               f"{float(img.max()):.4f}; binning {stats}; dropped share "
               f"{share:.3e} (limit {MAX_DROPPED:g}); peak device memory "
               f"{peak:.2f} GiB")
        check(share < MAX_DROPPED, f"dropped share {share} >= {MAX_DROPPED}")

        def frame():
            render_tiled_keys(g, cam, depth=DEPTH, tile=TILE, **kw)
            torch.cuda.synchronize()

        frame()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            frame()
            host.append((time.perf_counter() - t0) * 1e3)
        frame_ms = statistics.median(host)
        stages = [stage_times(g, cam, kw) for _ in range(3)]
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    say(5, f"frame time {frame_ms:.2f} ms (host clock with sync, median of "
           f"5) = {w * h / frame_ms * 1e3 / 1e6:.2f} M rays/s; device "
           f"stages (CUDA events, median of 3): "
           + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items()))
    return launches, med["keys"]


def run():
    if not (ROOT / "rtgs_tpu_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"no rtgs_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    from rtgs_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    say(1, f"{smi} | {torch.cuda.get_device_name(0)} x"
           f"{torch.cuda.device_count()} | torch {torch.__version__} CUDA "
           f"{torch.version.cuda} | python {sys.version.split()[0]} | "
           f"{nvcc.strip().splitlines()[-1]}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    say(2, f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s; "
           + ptxas_summary(lib_path.with_suffix(".log").read_text()))

    from rtgs_tpu_torch.scene import random_scene

    g100k = random_scene(CFG_100K["n"], device=dev, **SCENE)
    case_100k = phase3_case("100k@640x384", g100k, CFG_100K, dev)
    g1m = random_scene(CFG_1M_GATE["n"], device=dev, **SCENE)
    case_1m = phase3_case("1M@256x192", g1m, CFG_1M_GATE, dev)
    frame_parity(g1m, CFG_1M_GATE, dev)
    phase4_precision(case_100k)
    del g100k, case_1m["packed"], case_1m["pix"]

    with tempfile.TemporaryDirectory() as tmp:
        launches, keys_ms_full = phase5_main_path(g1m, dev,
                                                  pathlib.Path(tmp))
    check("jax" not in sys.modules, "something imported jax")

    kernels = [{
        "name": "keys_sid",
        "route": "cuda",
        "source": "rtgs_tpu_torch/ops/csrc/keys.cu",
        "replaces": "rtgs_tpu/ops/peel.py:589",
        "launches": launches,
        "max_abs_err": max(case_100k["max_abs_err"],
                           case_1m["max_abs_err"]),
        "ms": case_100k["ms"],
        "plain_ms": case_100k["ms_twin"],
    }]
    say(6, f"keys kernel at 1M@1920x1088: {keys_ms_full:.2f} ms per frame "
           f"over {BANDS} bands; ms/plain_ms below are 100k@640x384")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
