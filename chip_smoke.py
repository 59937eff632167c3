#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (rtgs_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. It times nothing:
the card's times come from ``benchmark/`` and the probes (``probes.ktime``,
``probes.stages``, ``probes.samebits``). Phases, one line or more each (any
failed check exits non-zero, and nothing falls back to the CPU):

  1. device and toolchain: card name and power limit, torch, CUDA, nvcc;
     and one stamp line: nvcc's release, the GPU driver version,
     ``torch.__version__``, ``torch.version.cuda`` and whether triton
     imports;
  2. build the CUDA kernels (eleven sources) from the sources in this
     checkout, and print each kernel's registers and spills;
  3. the keys kernel against its plain torch twin at the main path's
     shapes — 100k splats at 640x384 and 1M splats at 256x192 — bitwise,
     with and without the early-exit bounds, with the share of (pixel,
     candidate) pairs its f32 screen rejects; a whole 256x192 frame
     through the kernel against one through the twin; and a scene that
     strains the screen, needles and discs (scale ratio >= 100 within a
     splat) seen from 0.2 and from 50 units away: every row of the f32
     table positive definite, chunk_lb a lower bound of the twin's t1
     field on every tile, the full sweep and the early exit both bitwise
     the twin's on every tile;
  4. precision of the kernel's winning t1 against float64 recomputed from
     the same f32 inputs;
  5. the render path through the CLI: ``render`` and a 3-frame ``orbit``
     of a 1M-splat scene at 1920x1088, depth 16, 8 tile bands; every frame
     must have launched the keys kernel once per band; the image is checked
     (finite, not black, dropped candidates < 0.1%);
  6. the fused-peel kernels (forward and backward) against their plain
     torch twins at the fit configuration (100k splats at 512x384, K 16,
     1536 candidates) and at 1M splats at 256x192: winners' slots bitwise,
     radiance and transmittance to an absolute tolerance; the backward
     kernel's pair rows against the twin's per-slot rows, and the (N+1, 64)
     table gradient (pair rows summed by segment_rows.cu) against index_add_
     of the twin's per-slot gradients, per lane relative to the lane's
     largest entry, its sentinel row exactly 0, and a second launch bitwise
     the first; the share of pairs the forward sweep's f32 screen rejects;
     the winners' α against float64 from the same f32 inputs;
  7. the training path through the CLI: ``fit --renderer pallas`` from
     scratch on the 100k scene at 512x384, depth 16, 12 views, 20 steps, 2
     tile bands, a checkpoint every 10 steps; the forward kernel must have
     launched once per band for every target render and every step, the
     backward kernel and segment_rows.cu once per band for every step;
  8. the fitbench protocol in process: the 100k ground truth perturbed
     by ``probes.fitbench.perturb`` (means σ 0.01, log-scales 0.3, color
     logits 0.5; a ``torch.Generator`` seeded with 7), 50 ``Solver``
     steps with one density-control pass and one opacity reset; PSNR must
     rise and the final scene's binning drop less than 0.1%; peak device
     memory is printed;
  9. the K-list path (the top-K peel, uncomposited) at the fit
     configuration and at 1M splats at 256x192: both top-K kernels against
     their plain twins (slots and t1 bitwise, α and rgb to an absolute
     tolerance, the (N+1, 64) table gradient per lane as in phase 6, a
     second launch bitwise the first); the winners and their
     α equal to the fused forward kernel's; the NaN/inf share of each
     output (t1 is +inf exactly on vacant layers); then the main path, a
     scene gradient of Σ w·radiance + Σ transmittance through
     ``composite_hits(*peel_topk(...))``, against the same through
     ``peel_fused``: images to 1e-5, the packed table's gradient per lane
     to 1e-4 of the lane's largest entry, each scene field's gradient to
     1e-2 of the field's largest entry at the 0.99 quantile (5e-2 for
     rotations and scales; its maximum and relative L2 norm printed), and
     the fused path's scene gradient bitwise a second run of itself;
 10. the oracle through the CLI: ``render --renderer oracle`` of a
     4096-splat scene at 640x384 against the keys render of the same scene
     (the statistic of tests/_utils.assert_images_close); ``fit --renderer
     oracle`` for 5 steps at 128x96;
 11. the ``tiled`` renderer through the CLI: ``render --renderer tiled`` of
     the 100k scene at 640x384 against its keys render (and the winners of
     the pixel where the two differ most, as each lists them); ``fit
     --renderer tiled`` for 5 steps on the 4096-splat scene at 128x96;
 12. the keys path's backward at the fit configuration: the hand-written
     backward of ``shade_winners_kp`` against torch autograd of its plain
     forward (per lane, relative to the lane's largest entry), bitwise a
     second run of itself; scene gradients of Σ image through
     ``render_tiled_keys`` against ``render_tiled_pallas`` (phase 9's
     limits), banded against unbanded, a second run bitwise the first, no
     NaN; then the benchmark protocol of the repository (forward with
     the binning counters, and the gradient of Σ image) at its three
     configurations, 100k at 640x384, 250k at 1280x720 and 1M at 1920x1088
     in 8 bands, with zero dropped candidates, peak memory and the keys
     kernel's launches of one step (2 per band under recomputation);
 13. ``fit --renderer keys`` and ``bench`` through the CLI at the fit
     configuration (phase 7's protocol), launches counted; the 50-step
     re-fit of phase 8 through ``keys``, whose PSNR must rise;
 14. the probes: every variant of the three probe kernels against its
     plain version at the probes' sizes (kmicro 960x256x128; kprobe and
     lpprobe at 100k, 640x384, budget 1536); kprobe's shade variants once
     more with a +inf state, where their result is the minimum of their
     shading terms, against the plain minimum; a wrapper refuses what its
     kernel does not take; then the three probes as programs (``python -m
     rtgs_tpu_torch.probes.<name>``'s main, its output dropped), launches
     counted;
 15. the browser viewer (``viewer.server``, what ``serve`` runs) on the 1M
     scene at 1920x1088 in 8 tile bands, over HTTP on a free port: the page,
     a PNG frame bitwise the in-process render of its pose, a repeated
     frame that renders nothing, a new frame after each of a pan, a zoom
     and a rotation, 8 keys launches a fresh frame; then
     ``ProgressiveSampler`` (4 jittered samples equal to
     ``render_progressive`` of the same seed; 4 unjittered ones bitwise one
     render);
 16. the ring renderer (``parallel.render``) on a 1x1 mesh, one rank in an
     NCCL group (one card cannot hold more: NCCL refuses two ranks on one
     device): ``render_tiled_sharded`` of the 1M scene at 1920x1088 bitwise
     ``render_tiled_keys``, one keys launch a ring step; its scene
     gradients of Σ image² at the fit configuration, with torch's
     deterministic mode off, bitwise a second run of themselves and
     bitwise the unbanded keys path's (one ``segment_rows`` launch: the
     owner's sum); 5 sharded training steps (``make_sharded_train_step``)
     bitwise 5 one-card keys steps, at the fit cell and at the JAX dry
     run's full scale (100k at 256x256, depth 8); ``render_sharded`` of
     the 4096-splat scene at 128x96 against ``composite_rays`` to 1e-5;
 17. the LBVH of the 1M scene: the tree's structure, ``bvh_hit`` of 1,024
     seeded rays at max_steps 4096 against a brute-force nearest hit
     (uncut rays: the same splat but for ties within 1e-6, t1 to 1e-5; cut
     rays: never a nearer t1), how many rays are cut; and
     ``utils.profiling.trace`` around a 100k keys render, whose Chrome
     trace must name the keys kernel;
 18. determinism, with torch's deterministic mode off (asserted):
     segment_rows.cu against its CPU twin on the card's inputs (the fused
     backward's pair rows and the keys path's winner ids at 100k@512x384
     and 1M@256x192), bitwise; then at the four shapes of
     probes.ktime.segment_inputs (those pair rows and the fit
     configuration's winner rows, and the winner rows of the busiest of 8
     bands of the keys backward at 1M@1920x1088) bitwise its CPU twin and
     a second launch, rows no id names +0.0; the fused, top-K and keys
     backwards at those two configurations, each twice, bitwise; the keys
     path's forward+backward at 1M@1920x1088 in 8 bands twice, bitwise; 20
     training steps (a density-control pass at step 10) through ``pallas``
     and through ``keys`` twice from the same state, every parameter and
     every step's loss and PSNR bitwise; the ``oracle`` and ``tiled``
     gradients twice, printed as bitwise or not (plain torch autograd).
     Any other mismatch fails the run;
 19. deep peels, more layers than one kernel's list holds (64), run in
     passes above each pixel's floor: the keys kernel chained at depth 65,
     96, 128 and 256 at 1M@256x192 bitwise one twin call, one launch a
     pass (and 96 and 128 also cut into other passes); the fused and top-K
     forwards chained at depth 128 at the fit configuration and at
     1M@256x192, slots (and top-K t1) bitwise one twin call's, their
     backwards under autograd against one twin backward at 128 (also on
     the splats that win only past layer 64); ``render -d 128`` and a
     3-frame ``orbit`` through the CLI at 1M@1920x1088 in 8 bands (2 keys
     launches a band); in process at depth 16, 64 and 128 the frame with
     its passes launched here bitwise ``render_tiled_keys``', peak memory
     and the residual transmittance (mean, p99); 20 fit steps at depth 128
     through ``pallas`` and ``keys`` twice (PSNR must rise, every parameter
     bitwise); one ``serve`` frame at depth 128, bitwise the in-process
     render;
 20. the default path, with no renderer named (``auto``: the fused kernel
     on the card above 4096 splats) at 1M@1920x1088 with phase 19's
     budgets: ``render`` and a 3-frame ``orbit`` at depth 16, ``render`` at
     64 and 128 and ``bench`` through the CLI, ``peel_fwd`` once a band and
     pass and the keys kernel never; in process at depth 16, 64 and 128
     the frame bitwise its passes launched here, peak memory and dropped
     pairs (0) beside the keys path's frame, the images to the image
     statistic; the frame at 16 against the fused twin's; the busiest
     band's ``peel_fwd`` bitwise its twin at depth 16 and 64; ``serve``
     over HTTP (a first frame bitwise the in-process render, a cached one
     launching nothing, pan, zoom, rotation; no pose drops a pair);
     ``ProgressiveSampler`` x4 jittered at the smallest budget whose padded
     binning drops nothing, bitwise ``render_progressive``; the oracle
     against the fused path at 4096 and 4097 splats at 1920x1088 and
     640x384 (``auto`` takes each side of the threshold); ``peel_fwd.cu``'s
     registers and blocks an SM at K = 16 and 64 from the build's report
     (the deep pass must keep 16 warps an SM or more and spill nothing);
 21. the JAX package's production-scale tools through the port's probes
     (``probes.make_scene``, ``fitbench``, ``fitscratch``, ``imquality``,
     ``trace_step``, ``stages``), each through its function at the
     scripts' sizes: the structured scene (a ground plane, three clusters
     and a shell) written by the probe's CLI at 1M and 250k and reloaded;
     its per-tile candidate counts from the bench pose and seen whole
     (radius 10) beside the uniform scene's; ``render`` of it through the
     CLI at 1920x1088 (default and keys, 8 bands) and the JAX package's
     250k command (``--renderer pallas --max-candidates 2048 --tile-bands
     4`` at 1280x720) at its own budget and at the least clean one, 0
     dropped pairs wherever asserted; its busiest band through
     ``peel_fwd`` bitwise the twin; fitbench (300 steps, 12 views)
     through ``pallas`` and ``keys``, PSNR rising; fitscratch on the
     uniform box its script fits (150 steps: fault F11, reported) and on
     the structured scene (1,200 steps through ``auto``: growths, live
     count and PSNR rise asserted by step 800, where the f32 exponent (F2)
     starts to blow up steps, the tail reported; Adam's state after every
     step, the ``.ply`` round trip, 0 dropped pairs, its first 300 steps
     again bitwise, 300 through ``keys``); imquality's
     keys and auto rows at the three bench configurations, bitwise their
     twins and >= 40 dB / 0.999 SSIM against the oracle where it runs,
     beside the JAX package's TPU quality record; a profiler trace of 3
     training steps naming peel_fwd, peel_bwd and segment_rows; the stage
     tables of both renderers at 100k@640x384 and 1M@1920x1088 dropping
     no pair;
 22. the binning kernels (``binning.cu``, ``tile_candidates_cuda``)
     against the plain chain (``tile_candidates_torch`` on the same CUDA
     tensors) at the benchmark's two configurations (1M@1920x1088, budgets
     4608 / 128 / narrow 4, and 100k@512x384, 1536 / 128, from the bench
     pose), bitwise on every field, with the fused path's arguments and
     with the keys path's (``chunk=CHUNK`` and ``entry_lb`` from
     ``entry_lower_bound``); its launches on the main path: one
     ``render(auto)`` and one ``render(keys)`` frame at 1M@1920x1088, one
     binning each;
 23. the features kernels (``features.cu``: ``feature_table_cuda``,
     ``pixel_table_cuda``) against the plain chains
     (``precompute_features_torch`` + ``pack_features``,
     ``pixel_table_torch``, on the same CUDA tensors) at 1M@1920x1088 from
     three orbit poses: the (N+1, 64) table, its c0 (inf sentinel) and the
     (T, P, 24) pixel table bitwise, with and without a sub-pixel offset;
     their launches on the main path: one ``render(auto)`` and one
     ``render(keys)`` frame at 1M@1920x1088 without grad, one launch of
     each kernel a frame.
Then every hand-written kernel must have been launched on its main path
(the line of launches by kernel), and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
if not (ROOT / "rtgs_tpu_torch" / "__init__.py").is_file():
    sys.exit(f"chip_smoke: FAILED: no rtgs_tpu_torch package beside "
             f"{__file__}")
sys.path.insert(0, str(ROOT))
# The bench scene (bench.py: splats in a cube of half-size 2) and pose
# (orbit θ 0.4, φ 1.2, r 5, 60° vertical FOV), and its camera.
from rtgs_tpu_torch.probes._common import (  # noqa: E402
    BENCH_POSE, BENCH_SCENE, bench_camera)

DEPTH = 16
TILE = (16, 16)
CFG_100K = dict(n=100_000, res=(640, 384), max_candidates=1536,
                max_global=128, bin_narrow=3)
CFG_1M_GATE = dict(n=1_000_000, res=(256, 192), max_candidates=3584,
                   max_global=128, bin_narrow=4)
# The scene that strains the keys kernel's screen: needles and discs in a
# cube of half-size 0.5, the camera `gap` units from the cube's
# circumscribed sphere, with a field of view that keeps the cloud in frame.
CFG_ANISO = dict(n=50_000, extent=0.5, seed=4, res=(256, 192),
                 max_candidates=3584, max_global=512)
ANISO_VIEWS = ((0.2, 60.0), (50.0, 2.0))   # (gap, vertical FOV in degrees)
FULL_RES = (1920, 1088)
BANDS = 8
ORBIT_FRAMES = 3
MAX_DROPPED = 1e-3
MAX_T1_REL_P999 = 1e-4
# The repository's training configuration (BASELINE.json config 4, the
# fit_100k@512x384_12views run of scripts/fitbench.py).
CFG_FIT = dict(n=100_000, res=(512, 384), max_candidates=1536,
               max_global=128, bin_narrow=None)
FIT_VIEWS = 12
FIT_CLI_STEPS = 20
FIT_CLI_BANDS = 2
FIT_STEPS = 50
# Tiles per call of a plain twin (bounds its (T, P, C) float64 fields).
PLAIN_BAND = 96
# Kernel vs twin: same f32 shading in the same order, so radiance and
# transmittance agree to 1e-5; the backward sums each slot's row and each
# splat's rows in fixed orders (bitwise repeatable), but the twin's
# products run in torch's elementwise kernels and its table is an
# index_add_ on the card (no fixed order), so each lane of the (N+1, 64)
# table agrees to 1e-4 of the lane's largest entry.
FWD_ATOL = 1e-5
BWD_LANE_RTOL = 1e-4
MIN_PSNR_RISE = 0.5
# The K-list path against the fused path: the same winners, composited in
# another summation order (images to FWD_ATOL); the gradient of the packed
# table through both, per lane, to SCENE_GRAD_RTOL of the lane's largest
# entry (another order of f32 operations); that is the kernels' check.
# The scene gradients, per field, to SCENE_Q99 of the field's largest entry
# at the 0.99 quantile. The chain from the table to rotations and scales
# cancels (A, Me and c0 all carry Σ⁻¹, and e = origin − μ is ~500 splat
# scales long at the bench scene), so the table's f32 rounding grows there
# by ~10⁴ (on an H100: scales 9.3e-3 and rotations 2.2e-3 at the 0.99
# quantile at 100k @ 512x384; a few splats dominate even the L2 norm);
# those two fields are held to ROT_SCALE_Q99. A second run of the fused
# path must give its gradient bitwise (no atomics on either stage).
SCENE_GRAD_RTOL = 1e-4
SCENE_Q99 = 1e-2
ROT_SCALE_Q99 = 5e-2
# The oracle's scene: the JAX package's brute-force limit (_ORACLE_MAX_N).
# Its splats are larger than the bench scene's: the tile paths' f32
# exponent B²/4A − (c0+3) cancels by (distance / scale)², and with the
# bench's scales their α would differ from the oracle's (accurate to ~1e-6
# against float64) by more than the image statistic allows.
ORACLE_N = 4096
SCENE_4K = dict(extent=1.5, scale_range=(0.05, 0.2), seed=0)
ORACLE_RES = (640, 384)
SMALL_FIT = dict(res=(128, 96), views=4, steps=5, init_points=2048,
                 max_candidates=2048)
# Image against image of another renderer (tests/_utils.assert_images_close).
IMG_Q, IMG_QTOL, IMG_MAXTOL = 0.99, 5e-4, 0.12

# The interactive viewer's configuration: phase 5's frame (1M @ 1920x1088,
# K 16, budgets 3584 / 64 / narrow 4, 8 tile bands).
SERVE_KW = dict(max_candidates=3584, max_global=64, tile_bands=BANDS,
                bin_narrow=4)
SERVE_EVENTS = ({"type": "pan", "dx": 0.05, "dy": 0.02},
                {"type": "zoom", "delta": 1},
                {"type": "rot", "rx": 0.3, "ry": 0.2, "rz": 0.0})
PROGRESSIVE_SAMPLES = 4
# The ring against the single-device keys path (tests/test_parallel.py:
# 138): the same winners shaded and composited in the same order, and its
# scene gradients summed in one card's order: both bitwise. The sharded
# training step: RING_STEPS steps bitwise the one-card keys steps, at the
# fit cell and at the JAX package's dry run at full scale
# (__graft_entry__.py:98-100: 100k @ 256x256, depth 8, budgets 512 / 64).
RING_STEPS = 5
DRY_N, DRY_RES, DRY_DEPTH = 100_000, (256, 256), 8
DRY_BUDGETS = dict(max_candidates=512, max_global=64)
RING_ORACLE_RES = (128, 96)
# LBVH queries: seeded origins on a sphere of radius 5 aimed at the origin.
BVH_RAYS, BVH_RADIUS, BVH_MAX_STEPS = 1024, 5.0, 4096
BVH_TIE_RTOL, BVH_T1_RTOL = 1e-6, 1e-5
BVH_BRUTE_CHUNK = 32


# The roofline arithmetic below (the peaks, the operation counts, bound,
# peel_bound and segment_bound) is no longer called here: it stays, byte for
# byte, because benchmark/tests/test_bench_bounds.py reads it from this
# file's source to hold benchmark/bounds.py's frozen copy against it.
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): device memory
# 3.35 TB/s, float32 67 TFLOP/s and float64 34 TFLOP/s outside the tensor
# cores (the kernels use none).
HBM_BPS, F32_OPS, F64_OPS = 3.35e12, 67e12, 34e12
# Operations per unit of work, counted from the sources. Per (pixel, live
# candidate) the float64 entry-depth chain: A 11, B 6, Δ 4. Per winner, f32:
# quad 28 (A, B, Δ, the exponent, exp, α), three colors 30 each, composite
# 9; the backwards re-shade and add ~60 products and 59 sums per winner
# (and the fused one ~30 for its recurrences).
SWEEP_F64 = 21
SHADE_F32 = dict(peel_fwd=127, peel_topk_fwd=118, peel_bwd=280,
                 peel_topk_bwd=250)
# Probe kernels against their plain versions: exp, exp2 and log are the
# CUDA math library's in both, but need not compile to the same code
# (2 ulp); sums run in another order (1e-5 relative); all else bitwise.
ULP_VARIANTS = ("exp", "exp2", "exp_where")
SUM_RTOL = 1e-5
SHADE_TOL = 1e-6
# Deep peels (phase 19): more layers than one kernel's list holds, run in
# passes above each pixel's floor. The chains against one twin call at
# these depths; the CLI, fits and viewer at DEEP; frames at FRAME_DEPTHS;
# and two more ways to cut 96 and 128 layers into passes.
CHAIN_DEPTHS = (65, 96, 128, 256)
DEEP = 128
FRAME_DEPTHS = (16, 64, 128)
PASS_SPLITS = {96: ((64, 32), (48, 48)), 128: ((64, 64), (32, 32, 32, 32))}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def run_quiet(main, argv):
    """``main(argv)`` (a probe's or the CLI's) with what it prints
    dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def toolchain_stamp(nvcc_version: str) -> str:
    """nvcc's release, the GPU driver version, torch and its CUDA, and whether
    triton imports (no kernel of the port is Triton yet; a later one may)."""
    import torch

    release = re.search(r"release ([^,\s]+)", nvcc_version)
    gpu_driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    try:
        import triton

        tri = f"triton {triton.__version__} imports"
    except Exception as e:  # noqa: BLE001 - any failure is the answer
        tri = f"triton does not import ({type(e).__name__})"
    return (f"nvcc release {release.group(1) if release else '?'}, GPU "
            f"driver {gpu_driver}, torch {torch.__version__}, "
            f"torch.version.cuda {torch.version.cuda}, {tri}")


def ptxas_summary(log: str) -> str:
    """One entry per kernel instantiation from nvcc's ``-Xptxas -v``."""
    out, name, frame, threads = [], "?", "", 256
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)ILi(\d+)E", m.group(1))
            # The probes' templates are indexed by variant, not by K.
            what = ("variant " if k and k.group(1) in (
                "micro_kernel", "sweep_kernel") else "K=")
            name = f"{k.group(1)} {what}{k.group(2)}" if k else m.group(1)
            if "ELb1E" in m.group(1):
                name += " counting"
            # peel_fwd's deep pass (K > 16) runs blocks of 512: a lane pair
            # a pixel.
            threads = 512 if (k and k.group(1) == "peel_fwd_kernel"
                              and int(k.group(2)) > 16) else 256
            if "table_kernel" in m.group(1):     # features.cu: 128 splats
                threads = 128
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            # Registers are granted in units of 8 a thread; an SM has 65,536.
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            fit = 65536 // (-(-regs // 8) * 8 * threads)
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}; "
                       f"registers let {fit} blocks of {threads} threads "
                       f"({fit * threads // 32} warps) on an SM")
    return " | ".join(out)


def bound(nbytes, f32_ops=0.0, f64_ops=0.0):
    """The least time (ms) the card could take: the bytes over the memory
    rate against the operations over the peak of their type. Returns
    (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (f32_ops / F32_OPS + f64_ops / F64_OPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def peel_bound(kind, shape):
    """Bound of a production kernel from one run's inputs: ``shape`` holds
    T, C, P, the table's rows n, the live (tile, candidate) pairs and, for
    the fused and top-K kernels, the winners (non-vacant layers). Inputs
    once: the live ids, each referenced row once (40 bytes for the keys
    kernel, which reads lanes 0-9; 236 for the others), the pixel lanes the
    kernel reads (9 for the keys kernel: direction and quadratic features;
    all 24 for the others, which also shade), counts and bounds. Outputs
    once, and of the backwards' gradient one row a live pair (the rows the
    kernels add into the table): the same work whatever implements it."""
    t, c, p = shape["t"], shape["c"], shape["p"]
    live, k = shape["live"], DEPTH
    rows = min(live, shape["n"])
    common = live * 4 + t * 4
    layers = t * k * p * 4
    sweep = live * p * SWEEP_F64
    if kind == "keys_sid":
        return bound(common + t * p * 9 * 4 + rows * 40
                     + t * (c // 128 + 1) * 4 + 2 * layers, f64_ops=sweep)
    common += t * p * 24 * 4 + rows * 236
    shade = shape["winners"] * SHADE_F32[kind]
    if kind == "peel_fwd":
        return bound(common + t * p * 16 + layers, shade, sweep)
    if kind == "peel_topk_fwd":
        return bound(common + 6 * layers, shade, sweep)
    grads = t * p * 16 if kind == "peel_bwd" else 4 * layers
    return bound(common + layers + grads + live * 64 * 4, shade)


def keys_inputs(g, cfg, dev, cam=None):
    from rtgs_tpu_torch.ops.peel import CHUNK, _counts
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features)

    cam = bench_camera(cfg["res"], dev) if cam is None else cam
    packed = pack_features(precompute_features(g, cam))
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=cfg["max_candidates"],
                        max_global=cfg["max_global"],
                        narrow=cfg["bin_narrow"], chunk=CHUNK,
                        entry_lb=entry_lower_bound(g, cam, packed))
    pix = _tile_pixel_features(cam, TILE)
    return cam, packed, b.candidates, _counts(b.candidates), b.chunk_lb, pix


def phase3_case(label, g, cfg, dev):
    """Kernel vs twin, bitwise, at one configuration; returns the kernel's
    outputs and inputs."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda, peel_keys_torch

    _, packed, cand, counts, lb, pix = keys_inputs(g, cfg, dev)
    zeros = torch.zeros_like(lb)
    t1_k, sid_k = peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)
    t1_f, sid_f = peel_keys_cuda(packed, cand, counts, zeros, pix, DEPTH)
    t1_t, sid_t = peel_keys_torch(packed, cand, pix, DEPTH)
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
    pairs, rejected = screen_share(packed, cand, counts, zeros, pix,
                                   (t1_f, sid_f))
    t, c = cand.shape
    say(3, f"keys {label}: T={t} C={c} P={pix.shape[1]} K={DEPTH}: ids and "
           f"t1 bitwise equal to the twin, and with chunk_lb bitwise equal "
           f"to the full sweep; the f32 screen rejects {rejected} of {pairs} "
           f"(pixel, live candidate) pairs of the full sweep = "
           f"{rejected / pairs:.2%} before the float64 chain")
    return dict(packed=packed, pix=pix, t1=t1_k, sid=sid_k)


def screen_share(packed, cand, counts, lb, pix, want):
    """(pairs evaluated, pairs the screen rejected) of one sweep, from the
    kernel's counting instantiation, whose result must equal ``want``."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda

    counters = torch.zeros(2, dtype=torch.int64, device=packed.device)
    t1, sid = peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH,
                             screen_counts=counters)
    check(torch.equal(t1, want[0]) and torch.equal(sid, want[1]),
          "the counting keys kernel differs from the uncounted one")
    pairs, rejected = (int(x) for x in counters)
    check(0 <= rejected <= pairs and pairs > 0,
          f"screen counters {pairs}, {rejected}")
    return pairs, rejected


def sweep_screen_share(packed, cand, counts, pix, want_slots):
    """(pairs swept, pairs the screen rejected) of ``sweep_topk`` on these
    inputs, from the fused forward's counting instantiation, whose winners
    must equal ``want_slots``."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_fused_cuda

    counters = torch.zeros(2, dtype=torch.int64, device=packed.device)
    slots = peel_fused_cuda(packed, cand, counts, pix, DEPTH,
                            screen_counts=counters)[2]
    check(torch.equal(slots, want_slots),
          "the counting forward kernel differs from the uncounted one")
    pairs, rejected = (int(x) for x in counters)
    check(0 <= rejected <= pairs and pairs > 0,
          f"sweep screen counters {pairs}, {rejected}")
    return pairs, rejected


def phase3_anisotropic(dev):
    """The keys kernel against its twin on needles and discs seen from very
    near and very far, where Δ cancels hardest, the screen's margin is
    widest and the f32 table is farthest from the exact ellipsoid: every
    row of the table positive definite, chunk_lb a bound on every tile, the
    early exit bitwise the twin's on every tile."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.ops.peel import (CHUNK, _counts, _safe_ids,
                                         entry_depth, peel_keys_cuda,
                                         peel_keys_torch)
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features)
    from rtgs_tpu_torch.scene import anisotropic_scene
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    cfg = CFG_ANISO
    g = anisotropic_scene(cfg["n"], extent=cfg["extent"], seed=cfg["seed"],
                          device=dev)
    ratio = g.scales.amax(-1) / g.scales.amin(-1)
    for gap, fov in ANISO_VIEWS:
        pos, rot, _, _ = orbit_camera_pose(
            BENCH_POSE["theta"], BENCH_POSE["phi"],
            cfg["extent"] * math.sqrt(3.0) + gap,
            np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
        cam = camera_from_fov(pos, rot, cfg["res"], fov, device=dev)
        packed = pack_features(precompute_features(g, cam))
        kw = dict(tile=TILE, max_candidates=cfg["max_candidates"],
                  max_global=cfg["max_global"], chunk=CHUNK)
        b = tile_candidates(g, cam, entry_lb=entry_lower_bound(g, cam, packed),
                            **kw)
        geometric = tile_candidates(g, cam, **kw).chunk_lb
        pix = _tile_pixel_features(cam, TILE)
        cand, lb = b.candidates, b.chunk_lb
        counts = _counts(cand)
        t, c = cand.shape
        zeros = torch.zeros_like(lb)
        t1_f, sid_f = peel_keys_cuda(packed, cand, counts, zeros, pix, DEPTH)
        t1_k, sid_k = peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)
        t1_t, sid_t = plain_in_bands(
            lambda cb, qb: peel_keys_torch(packed, cb, qb, DEPTH), t, cand,
            pix)
        torch.cuda.synchronize()
        label = f"anisotropic, camera {gap:g} away, FOV {fov:g}"
        check(bool((sid_f >= 0).any()), f"{label}: no pixel has a hit")
        check(torch.equal(sid_f, sid_t) and torch.equal(t1_f, t1_t),
              f"{label}: the full sweep differs from the twin at "
              f"{int((sid_f != sid_t).sum())} ids")
        m00, m01, m02, m11, m12, m22 = packed[:-1, :6].double().unbind(-1)
        minor2 = m00 * m11 - m01 * m01
        det = (m00 * (m11 * m22 - m12 * m12) - m01 * (m01 * m22 - m12 * m02)
               + m02 * (m01 * m12 - m11 * m02))
        indefinite = int(((m00 <= 0) | (minor2 <= 0) | (det <= 0)).sum())
        check(indefinite == 0, f"{label}: {indefinite} rows of the f32 table "
              f"are not positive definite")

        # chunk_lb[t, c] must be a lower bound of every t1 of the chunks
        # from c on: then the early exit is exact.
        def bound_fails(cb, qb, lbb, geo):
            rows = packed[:, :10][_safe_ids(packed, cb)]
            cmin = entry_depth(rows, qb).amin(1).reshape(
                cb.shape[0], c // CHUNK, CHUNK).amin(2)
            suffix = torch.cummin(cmin.flip(1), dim=1).values.flip(1)
            return torch.stack([(suffix < lbb[:, :-1]).any(dim=1),
                                (suffix < geo[:, :-1]).any(dim=1)], dim=1)

        fails = plain_in_bands(bound_fails, t, cand, pix, lb, geometric)
        failing, geo_failing = (int(x) for x in fails.sum(dim=0))
        check(failing == 0, f"{label}: chunk_lb is no lower bound on "
              f"{failing} of {t} tiles")
        same = ((sid_k == sid_t) & (t1_k == t1_t)).all(dim=2).all(dim=1)
        check(bool(same.all()), f"{label}: the early exit changed "
              f"{int((~same).sum())} of {t} tiles")
        pairs, rejected = screen_share(packed, cand, counts, zeros, pix,
                                       (t1_f, sid_f))
        swept, _ = screen_share(packed, cand, counts, lb, pix, (t1_k, sid_k))
        hits = int((sid_f >= 0).sum())
        say(3, f"keys {label}: {g.num} splats, scale ratio within a splat "
               f"{float(ratio.min()):.0f}-{float(ratio.max()):.0f}, T={t} "
               f"C={c} P={pix.shape[1]} K={DEPTH}, {int((cand >= 0).sum())} "
               f"live pairs, {hits} winners: {indefinite} rows of the f32 "
               f"table with m00 <= 0 or a non-positive minor; chunk_lb fails "
               f"as a bound on {failing} of {t} tiles (depth - sqrt(3)*s_max "
               f"alone, without the table's measured error: on "
               f"{geo_failing}); the full sweep's ids and t1 bitwise equal "
               f"to the twin's, and with chunk_lb bitwise equal on all {t} "
               f"tiles, sweeping {swept} of {pairs} pairs = "
               f"{swept / pairs:.2%}; the f32 screen rejects {rejected} of "
               f"{pairs} pairs = {rejected / pairs:.2%}")


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


def frame_parity(g, cfg, dev, cam=None, phase=3, label="the 1M scene"):
    """One frame through the kernel and one through the twin: the same
    selection feeds the same shading, so the images must be equal. The
    twin runs in bands of at most PLAIN_BAND tiles (its float64 (tiles,
    256, C) fields are built whole per band), which selects the same."""
    import torch

    from rtgs_tpu_torch.render.tiled import render_tiled_keys

    cam = bench_camera(cfg["res"], dev) if cam is None else cam
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=cfg["max_candidates"],
              max_global=cfg["max_global"], bin_narrow=cfg["bin_narrow"])
    tiles = -(-cfg["res"][0] // TILE[0]) * -(-cfg["res"][1] // TILE[1])
    with torch.inference_mode():
        img_k = render_tiled_keys(g, cam, keys_impl="cuda", **kw)
        img_t = render_tiled_keys(g, cam, keys_impl="torch",
                                  tile_bands=-(-tiles // PLAIN_BAND), **kw)
    diff = float((img_k - img_t).abs().max())
    check(bool(torch.isfinite(img_k).all()), "frame parity: non-finite")
    check(diff == 0.0, f"frame parity: max |kernel − twin| = {diff}")
    say(phase, f"frame {cfg['res'][0]}x{cfg['res'][1]} of {label}: kernel "
               f"path equals twin path (max |diff| {diff})")


def phase5_main_path(g, dev, tmp):
    import numpy as np
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import save_scene

    ply = tmp / "scene_1m.ply"
    save_scene(ply, g)
    w, h = FULL_RES
    argv = ["-o", str(ply), "-r", f"{w},{h}", "-d", str(DEPTH),
            "--fov", str(BENCH_POSE["fov"]), "--radius", str(BENCH_POSE["r"]),
            "--theta", str(BENCH_POSE["theta"]),
            "--phi", str(BENCH_POSE["phi"]),
            "--max-candidates", "3584", "--tile-bands", str(BANDS),
            "--bin-narrow", "4", "--renderer", "keys", "--device", "cuda"]

    # The main path: one render and an orbit, through the CLI.
    peel_keys_cuda.launches = 0
    run_quiet(cli, ["render", *argv, "--output", str(tmp / "frame.npy")])
    run_quiet(cli, ["orbit", *argv, "--frames", str(ORBIT_FRAMES),
                    "--output", str(tmp / "orbit")])
    torch.cuda.synchronize()
    launches = peel_keys_cuda.launches
    frames = 1 + ORBIT_FRAMES
    say(5, f"CLI render + orbit --frames {ORBIT_FRAMES}: {frames} frames; "
           f"keys kernel launches {launches} (expected {BANDS} per frame = "
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

    # The same frame in process: values and binning counters.
    cam = bench_camera(FULL_RES, g.device)
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
    return launches


def table_in_bands(packed, fn, t, cand, *tiled):
    """The (N+1, 64) table gradient through a plain backward twin: its
    per-slot gradients (T, C, 64), band by band, scatter-added with
    ``index_add_``."""
    import torch

    from rtgs_tpu_torch.ops.peel import F_DIM, _safe_ids

    out = torch.zeros_like(packed)
    for s in range(0, t, PLAIN_BAND):
        band = cand[s:s + PLAIN_BAND]
        dfeats = fn(band, *(x[s:s + PLAIN_BAND] for x in tiled))
        out.index_add_(0, _safe_ids(packed, band).reshape(-1),
                       dfeats.reshape(-1, F_DIM))
    return out


def table_errors(label, got, ref):
    """A backward kernel's table gradient against the plain one: finite,
    the sentinel row exactly 0, each lane within ``BWD_LANE_RTOL`` of the
    lane's largest entry. Returns (max |diff|, the worst lane's share)."""
    import torch

    check(got.shape == ref.shape, f"{label}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite gradient")
    check(bool((got[-1] == 0).all()), f"{label}: the sentinel row has a "
          f"gradient")
    diff = (got - ref).abs()
    lane = float((diff.amax(dim=0) / (ref.abs().amax(dim=0) + 1e-30)).max())
    check(lane <= BWD_LANE_RTOL, f"{label}: per-lane error {lane} > "
          f"{BWD_LANE_RTOL}")
    return float(diff.max()), lane


def plain_in_bands(fn, t, *tiled):
    """Run a plain twin over tile bands of ``PLAIN_BAND`` tiles (its
    (T, P, C) float64 fields would not fit at once) and concatenate."""
    import torch

    outs = [fn(*(x[s:s + PLAIN_BAND] for x in tiled))
            for s in range(0, t, PLAIN_BAND)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def alpha_precision(packed, cand, pix, slots):
    """Relative error of the winners' f32 α (the kernels' arithmetic)
    against float64 from the same f32 inputs, over winners with α64 > 0;
    ``zeroed`` counts those whose f32 Δ came out ≤ 0 (α32 = 0): near a
    silhouette α jumps from op·e⁻³ to 0, and the cancelling Δ decides."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.ops.peel import _shade_layers, _winner_rows

    errs, zeroed = [], 0
    for s in range(0, cand.shape[0], PLAIN_BAND):
        sl = slots[s:s + PLAIN_BAND]
        rows = _winner_rows(packed, cand[s:s + PLAIN_BAND], sl)
        won = sl >= 0
        a32 = _shade_layers(rows, pix[s:s + PLAIN_BAND], won)[3]
        a64 = _shade_layers(rows.double(), pix[s:s + PLAIN_BAND].double(),
                            won)[3]
        check(bool(torch.isfinite(a32).all()), "non-finite α")
        ok = won & (a64 > 0)
        errs.append(((a32.double() - a64).abs() / a64)[ok].cpu().numpy())
        zeroed += int((ok & (a32 == 0)).sum())
    err = np.concatenate(errs)
    return dict(n=err.size, median=float(np.median(err)),
                p999=float(np.quantile(err, 0.999)), max=float(err.max()),
                zeroed=zeroed)


def phase6_case(label, g, cfg, dev):
    """Fused forward and backward kernels against their twins at one
    configuration, and the winners' α precision."""
    import torch

    from rtgs_tpu_torch.ops.peel import (peel_fused_bwd_cuda,
                                         peel_fused_bwd_torch,
                                         peel_fused_cuda, peel_fused_torch)

    _, packed, cand, counts, _, pix = keys_inputs(g, cfg, dev)
    t = cand.shape[0]
    swept = torch.arange(cand.shape[1], device=dev) < counts[:, None]
    rad_k, tr_k, sl_k = peel_fused_cuda(packed, cand, counts, pix, DEPTH)
    rad_p, tr_p, sl_p = plain_in_bands(
        lambda c, q: peel_fused_torch(packed, c, q, DEPTH), t, cand, pix)
    torch.cuda.synchronize()
    check(torch.equal(sl_k, sl_p), f"{label}: kernel winners differ from "
          f"the twin's at {int((sl_k != sl_p).sum())} entries")
    check(bool((sl_k >= 0).any()), f"{label}: no pixel has a hit")
    fwd_err = max(float((rad_k - rad_p).abs().max()),
                  float((tr_k - tr_p).abs().max()))
    check(fwd_err <= FWD_ATOL, f"{label}: forward max |kernel − twin| "
          f"{fwd_err} > {FWD_ATOL}")

    gen = torch.Generator(device=dev).manual_seed(0)
    g_rad = torch.randn(rad_k.shape, generator=gen, device=dev)
    g_tr = torch.randn(tr_k.shape, generator=gen, device=dev)

    def kernel_bwd():
        return peel_fused_bwd_cuda(packed, cand, counts, pix, sl_k, g_rad,
                                   g_tr, DEPTH)

    d_k = kernel_bwd()
    d_p = table_in_bands(
        packed, lambda c, q, sl, gr, gt: peel_fused_bwd_torch(
            packed, c, q, sl, gr, gt),
        t, cand, pix, sl_k, g_rad, g_tr)
    torch.cuda.synchronize()
    bwd_abs, bwd_lane = table_errors(f"{label}: backward", d_k, d_p)
    check(torch.equal(kernel_bwd(), d_k), f"{label}: a second launch of the "
          f"backward gives another table gradient")
    del d_p
    rows_k, ids_k = peel_fused_bwd_cuda(packed, cand, counts, pix, sl_k,
                                        g_rad, g_tr, DEPTH, table=False)
    check(torch.equal(ids_k, cand[swept]), f"{label}: the backward kernel's "
          f"pair ids are not the swept candidates")
    pair_lane, pair_same = pair_rows_against_twin(
        label, rows_k, plain_in_bands(
            lambda c, q, sl, gr, gt: peel_fused_bwd_torch(packed, c, q, sl,
                                                          gr, gt),
            t, cand, pix, sl_k, g_rad, g_tr), swept)
    del rows_k, ids_k
    alpha = alpha_precision(packed, cand, pix, sl_k)
    t, c = cand.shape
    say(6, f"fused {label}: T={t} C={c} P={pix.shape[1]} K={DEPTH}: winners "
           f"bitwise equal to the twin's; forward max |diff| {fwd_err:.3e} "
           f"(limit {FWD_ATOL:g}); backward max |diff| {bwd_abs:.3e}, per "
           f"lane {bwd_lane:.3e} of the lane's largest (limit "
           f"{BWD_LANE_RTOL:g}); a second backward bitwise the first; its "
           f"{int(swept.sum())} pair rows against the twin's per-slot rows: "
           f"per lane {pair_lane:.3e} of the lane's largest, {pair_same}")
    say(6, f"alpha {label}: {alpha['n']} winners vs float64 from the same "
           f"f32 inputs: median rel err {alpha['median']:.3e}, p99.9 "
           f"{alpha['p999']:.3e}, max {alpha['max']:.3e}; {alpha['zeroed']} "
           f"winners have α = 0 in f32 (f32 Δ ≤ 0) but not in float64 "
           f"(gate: finite)")
    pairs, rejected = sweep_screen_share(packed, cand, counts, pix, sl_k)
    say(6, f"fused {label}: the forward sweep's f32 screen rejects "
           f"{rejected} of {pairs} (pixel, live candidate) pairs = "
           f"{rejected / pairs:.2%} before the float64 chain")


def pair_rows_against_twin(label, rows, per_slot, swept):
    """A backward kernel's pair rows (M, 64) against the twin's per-slot
    rows (T, C, 64) of the swept slots: within ``BWD_LANE_RTOL`` of each
    lane's largest entry, lanes 59:64 exactly 0. Returns the worst lane's
    share and whether the two are bitwise equal (the same products summed
    in the same order; torch's elementwise kernels may round a product
    otherwise)."""
    ref = per_slot[swept]
    check(rows.shape == ref.shape, f"{label}: {tuple(rows.shape)} pair rows "
          f"for {tuple(ref.shape)} swept slots")
    check(bool((rows[:, 59:] == 0).all()), f"{label}: pair rows have "
          f"padding lanes")
    lane = float(((rows - ref).abs().amax(0)
                  / (ref.abs().amax(0) + 1e-30)).max())
    check(lane <= BWD_LANE_RTOL, f"{label}: pair rows per-lane error {lane}")
    n_diff = int((rows != ref).any(1).sum())
    same = ("bitwise equal" if n_diff == 0 else
            f"{n_diff} of {rows.shape[0]} rows differ in some bit")
    return lane, same


FIT_LINE = re.compile(r"fit (\d+) steps: loss=(\S+) psnr=(\S+) live=(\d+) "
                      r"-> (\S+)")


def phase7_fit_cli(g, tmp):
    """The training path through the CLI; returns the launch counts."""
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import (peel_fused_bwd_cuda,
                                         peel_fused_cuda, peel_keys_cuda,
                                         segment_rows_cuda)
    from rtgs_tpu_torch.scene import save_scene

    ply, out, ckpt = tmp / "scene_100k.ply", tmp / "fit.ply", tmp / "ckpt"
    save_scene(ply, g)
    w, h = CFG_FIT["res"]
    argv = ["fit", "-o", str(ply), "-r", f"{w},{h}", "-d", str(DEPTH),
            "--fov", str(BENCH_POSE["fov"]), "--radius", str(BENCH_POSE["r"]),
            "--views", str(FIT_VIEWS), "--steps", str(FIT_CLI_STEPS),
            "--from-scratch", "--renderer", "pallas", "--max-candidates",
            str(CFG_FIT["max_candidates"]), "--device", g.device.type,
            "--tile-bands", str(FIT_CLI_BANDS), "--checkpoint-every", "10",
            "--output", str(out), "--checkpoint-dir", str(ckpt)]
    peel_fused_cuda.launches = peel_fused_bwd_cuda.launches = 0
    peel_keys_cuda.launches = segment_rows_cuda.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli(argv)
    torch.cuda.synchronize()
    fwd, bwd = peel_fused_cuda.launches, peel_fused_bwd_cuda.launches
    seg = segment_rows_cuda.launches
    line = printed.getvalue().strip()
    say(7, f"CLI {' '.join(argv[:1] + argv[3:])}: printed '{line}'; fused "
           f"forward launches {fwd} (expected "
           f"{FIT_CLI_BANDS} x ({FIT_VIEWS} + {FIT_CLI_STEPS})), backward "
           f"{bwd} (expected {FIT_CLI_BANDS} x {FIT_CLI_STEPS}), its "
           f"segment sum {seg} (as many); keys kernel "
           f"{peel_keys_cuda.launches}")
    check(fwd == FIT_CLI_BANDS * (FIT_VIEWS + FIT_CLI_STEPS),
          f"fused forward launched {fwd} times")
    check(bwd == FIT_CLI_BANDS * FIT_CLI_STEPS,
          f"fused backward launched {bwd} times")
    check(seg == bwd, f"segment_rows launched {seg} times for {bwd} fused "
          f"backwards")
    m = FIT_LINE.search(line)
    check(m is not None, f"fit printed no result line: {line!r}")
    loss, psnr = float(m.group(2)), float(m.group(3))
    check(math.isfinite(loss) and math.isfinite(psnr),
          f"fit loss {loss}, psnr {psnr}")
    check(out.is_file() and out.stat().st_size > 0, "fit wrote no .ply")
    for step in (10, 20):
        check((ckpt / f"step_{step}.pt").is_file(),
              f"no checkpoint for step {step}")
    return fwd, bwd, seg


def refit_solver(g, ds, renderer, steps, depth=DEPTH, budgets=CFG_FIT,
                 densify=True):
    """The fitbench protocol's solver on the views ``ds``: the ground truth
    ``g`` perturbed as ``probes.fitbench.perturb`` perturbs it (means
    σ 0.01, log-scales 0.3, color logits 0.5; a ``torch.Generator`` seeded
    with 7), one density-control pass half way through ``steps`` (none
    without ``densify``) and one opacity reset after the last step (a
    reset inside them would leave no steps to recover); the binning's
    budgets from ``budgets``."""
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.probes.fitbench import perturb
    from rtgs_tpu_torch.train.solver import Solver, init_params

    params = perturb(init_params(g))
    mid = steps // 2 if densify else steps + 1
    cfg = TrainConfig(iterations=steps, densify_from=mid, densify_until=mid,
                      densify_every=mid, opacity_reset_every=steps,
                      checkpoint_every=0)
    return Solver(params=params, mask=g.mask, cfg=cfg,
                  cameras=list(ds.cameras), targets=list(ds.images),
                  depth=depth, renderer=renderer,
                  render_kwargs=fit_render_kwargs(budgets))


def fit_render_kwargs(cfg):
    """The binning's budgets of ``cfg`` as the renderers take them."""
    return dict(max_candidates=cfg["max_candidates"],
                max_global=cfg["max_global"], bin_narrow=cfg["bin_narrow"])


def phase8_fitbench(g, dev, renderer="pallas", phase=8):
    """Re-fit the perturbed 100k scene in process through ``renderer``: PSNR
    must rise; for ``pallas`` the final scene's binning must drop less than
    MAX_DROPPED."""
    import torch

    from rtgs_tpu_torch.render.tiled import render_tiled_pallas
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset

    kw = dict(max_candidates=CFG_FIT["max_candidates"],
              max_global=CFG_FIT["max_global"])
    ds = synthetic_orbit_dataset(g, FIT_VIEWS, CFG_FIT["res"],
                                 fov=BENCH_POSE["fov"], radius=BENCH_POSE["r"],
                                 depth=DEPTH, renderer=renderer, **kw)
    solver = refit_solver(g, ds, renderer, FIT_STEPS)
    mid = FIT_STEPS // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = solver.num_live
    psnrs = []
    for _ in range(FIT_STEPS):
        psnrs.append(solver.train_step()["psnr"])
        if solver.step == mid:
            live_after_densify = solver.num_live
    peak = torch.cuda.max_memory_allocated() / 2**30
    after_reset = solver.train_step()
    check(all(math.isfinite(p) for p in psnrs), "non-finite PSNR")
    check(math.isfinite(after_reset["loss"]), "non-finite loss after reset")
    # Mean PSNR over the first and the last full cycle of the views.
    first = statistics.mean(psnrs[:FIT_VIEWS])
    last = statistics.mean(psnrs[-FIT_VIEWS:])
    w, h = CFG_FIT["res"]
    say(phase, f"fitbench 100k@{w}x{h} through {renderer}, {FIT_VIEWS} views, "
               f"{FIT_STEPS} steps: PSNR "
               f"{first:.2f} -> {last:.2f} dB (means over the first and the "
               f"last {FIT_VIEWS} steps, each view once; rise limit "
               f"{MIN_PSNR_RISE:g} dB); curve "
               + " ".join(f"{p:.2f}" for p in psnrs[::5]) + f"; live {live0} "
               f"-> {live_after_densify} at the step-{mid} density pass "
               f"(capacity {solver.mask.shape[0]}); loss after the "
               f"step-{FIT_STEPS} opacity reset {after_reset['loss']:.5f}; "
               f"peak device memory {peak:.2f} GiB")
    check(last - first >= MIN_PSNR_RISE, f"PSNR through {renderer} rose "
          f"{last - first:.3f} dB, less than {MIN_PSNR_RISE} dB")
    if renderer != "pallas":
        return
    # The binning of view 0 at the final state.
    with torch.no_grad():
        _, stats = render_tiled_pallas(solver.scene(), ds.cameras[0],
                                       depth=DEPTH, with_stats=True, **kw)
    stats = {k: int(v) for k, v in stats.items()}
    dropped = stats["local_overflow"] + stats["global_overflow"]
    share = dropped / max(stats["live"] + dropped, 1)
    say(8, f"binning {stats}, dropped share {share:.3e} (limit "
           f"{MAX_DROPPED:g})")
    check(share < MAX_DROPPED, f"dropped share {share} >= {MAX_DROPPED}")


SCENE_FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


def phase9_case(label, g, cfg, dev):
    """The top-K kernels against their twins and against the fused peel at
    one configuration; returns the launches of its main path run (the
    K-list's scene gradient)."""
    import torch

    from rtgs_tpu_torch.ops.peel import (TOPK_LANES, _shade_layers,
                                         _winner_rows, peel_fused,
                                         peel_fused_cuda, peel_topk,
                                         peel_topk_bwd_cuda,
                                         peel_topk_bwd_torch, peel_topk_cuda,
                                         peel_topk_torch)
    from rtgs_tpu_torch.render.oracle import composite_hits
    from rtgs_tpu_torch.render.tiled import pack_features, precompute_features

    cam, packed, cand, counts, _, pix = keys_inputs(g, cfg, dev)
    t, p = cand.shape[0], pix.shape[1]
    lay_k, sl_k = peel_topk_cuda(packed, cand, counts, pix, DEPTH)
    lay_p, sl_p = plain_in_bands(
        lambda c, q: peel_topk_torch(packed, c, q, DEPTH), t, cand, pix)
    torch.cuda.synchronize()
    check(torch.equal(sl_k, sl_p), f"{label}: top-K winners differ from the "
          f"twin's at {int((sl_k != sl_p).sum())} entries")
    check(bool((sl_k >= 0).any()), f"{label}: no pixel has a hit")
    check(torch.equal(lay_k[:, 0], lay_p[:, 0]),
          f"{label}: top-K t1 differs from the twin's")
    fwd_err = float((lay_k[:, 1:] - lay_p[:, 1:]).abs().max())
    check(fwd_err <= FWD_ATOL, f"{label}: top-K α/rgb max |kernel − twin| "
          f"{fwd_err} > {FWD_ATOL}")

    # The fused forward kernel's winners, and their α as phase 6 shades
    # them.
    sl_f = peel_fused_cuda(packed, cand, counts, pix, DEPTH)[2]
    check(torch.equal(sl_f, sl_k), f"{label}: top-K winners differ from "
          f"the fused kernel's at {int((sl_f != sl_k).sum())} entries")
    alpha_f = plain_in_bands(
        lambda c, q, sl: _shade_layers(_winner_rows(packed, c, sl), q,
                                       sl >= 0)[3], t, cand, pix, sl_f)
    alpha_err = float((lay_k[:, 1] - alpha_f).abs().max())
    check(alpha_err <= FWD_ATOL, f"{label}: K-list α differs from the fused "
          f"winners' α by {alpha_err}")

    # NaN/inf share of each output (scripts/chip_parity.py's diagnosis).
    vacant = float((sl_k < 0).float().mean())
    shares = []
    for i, name in enumerate(TOPK_LANES):
        x = lay_k[:, i]
        nan, inf = float(x.isnan().float().mean()), float(
            x.isinf().float().mean())
        fin = x[torch.isfinite(x)]
        shares.append(f"{name} nan {nan:.2%} inf {inf:.2%} finite-mean "
                      f"{float(fin.mean()) if fin.numel() else 0.0:.4f}")
        check(nan == 0.0, f"{label}: {name} has NaN")
        check(inf == (vacant if name == "t1" else 0.0),
              f"{label}: {name} inf share {inf} (vacant share {vacant})")

    gen = torch.Generator(device=dev).manual_seed(1)
    g_lay = torch.randn((t, 4, DEPTH, p), generator=gen, device=dev)

    def kernel_bwd():
        return peel_topk_bwd_cuda(packed, cand, counts, pix, sl_k, g_lay,
                                  DEPTH)

    d_k = kernel_bwd()
    d_p = table_in_bands(
        packed, lambda c, q, sl, gl: peel_topk_bwd_torch(
            packed, c, q, sl, gl),
        t, cand, pix, sl_k, g_lay)
    torch.cuda.synchronize()
    bwd_abs, bwd_lane = table_errors(f"{label}: top-K backward", d_k, d_p)
    check(torch.equal(kernel_bwd(), d_k), f"{label}: a second launch of the "
          f"top-K backward gives another table gradient")
    del lay_p, sl_p, d_p, alpha_f

    # The main path: a scene gradient through the K-list, composited
    # outside the kernel, against the same through the fused peel.
    w = torch.randn((t, p, 3), generator=gen, device=dev)

    def scene_grad(through_topk):
        leaves = {f: getattr(g, f).detach().clone().requires_grad_()
                  for f in SCENE_FIELDS}
        scene = type(g)(mask=g.mask, **leaves)
        pk = pack_features(precompute_features(scene, cam))
        pk.retain_grad()
        if through_topk:
            t1, a, r, gg, b = peel_topk(pk, cand, pix, DEPTH)
            rad, trans = composite_hits(t1, a, torch.stack([r, gg, b], -1))
        else:
            rad, trans = peel_fused(pk, cand, pix, DEPTH)
            rad = rad.transpose(1, 2)
        ((rad * w).sum() + trans.sum()).backward()
        grads = {f: x.grad for f, x in leaves.items()}
        grads["packed"] = pk.grad
        return rad.detach(), trans.detach(), grads

    peel_topk_cuda.launches = peel_topk_bwd_cuda.launches = 0
    rad_k, tr_k, grads_k = scene_grad(True)
    torch.cuda.synchronize()
    launches = (peel_topk_cuda.launches, peel_topk_bwd_cuda.launches)
    check(launches == (1, 1), f"{label}: the K-list path launched the top-K "
          f"kernels {launches} times, expected (1, 1)")
    rad_f, tr_f, grads_f = scene_grad(False)
    torch.cuda.synchronize()
    comp_err = max(float((rad_k - rad_f).abs().max()),
                   float((tr_k - tr_f).abs().max()))
    check(comp_err <= FWD_ATOL, f"{label}: composite_hits(peel_topk) differs "
          f"from peel_fused by {comp_err} > {FWD_ATOL}")
    d_pk = (grads_k["packed"] - grads_f["packed"]).abs().amax(0)
    pk_err = float((d_pk / (grads_f["packed"].abs().amax(0) + 1e-30)).max())
    check(pk_err <= SCENE_GRAD_RTOL, f"{label}: K-list gradient of the "
          f"packed table differs from the fused path's by {pk_err} per lane")
    grads_f2 = scene_grad(False)[2]
    grads_k2 = scene_grad(True)[2]

    grad_errs = {}
    for f in (*SCENE_FIELDS, "packed"):
        check(torch.equal(grads_f2[f], grads_f[f]), f"{label}: a second "
              f"run of peel_fused gives another gradient of {f}")
        check(torch.equal(grads_k2[f], grads_k[f]), f"{label}: a second "
              f"run of the K-list path gives another gradient of {f}")
    for f in SCENE_FIELDS:
        check(bool(torch.isfinite(grads_k[f]).all()),
              f"{label}: non-finite scene gradient of {f}")
        grad_errs[f] = field_err(grads_k[f], grads_f[f])
        limit = ROT_SCALE_Q99 if f in ("quats", "scales") else SCENE_Q99
        check(grad_errs[f][1] <= limit, f"{label}: K-list scene gradient "
              f"of {f} differs from the fused path's by {grad_errs[f]} "
              f"(relative L2, q99 and max of the field's largest; q99 "
              f"limit {limit:g})")
    del grads_f2, grads_k2

    swept = torch.arange(cand.shape[1], device=dev) < counts[:, None]
    pair_lane, pair_same = pair_rows_against_twin(
        f"{label}: top-K",
        peel_topk_bwd_cuda(packed, cand, counts, pix, sl_k, g_lay, DEPTH,
                           table=False)[0],
        plain_in_bands(
            lambda c, q, sl, gl: peel_topk_bwd_torch(packed, c, q, sl, gl),
            t, cand, pix, sl_k, g_lay), swept)
    c = cand.shape[1]
    say(9, f"top-K {label}: T={t} C={c} P={p} K={DEPTH}: slots and t1 "
           f"bitwise equal to the twin's, α/rgb max |diff| {fwd_err:.3e} "
           f"(limit {FWD_ATOL:g}); winners bitwise the fused kernel's, α "
           f"max |diff| {alpha_err:.3e} from the fused winners' α; backward "
           f"max |diff| {bwd_abs:.3e}, per lane {bwd_lane:.3e} of the "
           f"lane's largest (limit {BWD_LANE_RTOL:g}), a second launch "
           f"bitwise the first; its pair rows against the twin's per-slot "
           f"rows: per lane {pair_lane:.3e} of the lane's largest, "
           f"{pair_same}")
    pairs, rejected = sweep_screen_share(packed, cand, counts, pix, sl_k)
    say(9, f"top-K {label}: its sweep is the fused forward's (sweep_topk), "
           f"whose f32 screen rejects {rejected} of {pairs} pairs = "
           f"{rejected / pairs:.2%} on these inputs")
    say(9, f"outputs {label} (vacant share {vacant:.2%}): "
           + "; ".join(shares))
    say(9, f"main path {label}: scene gradient of Σ w·radiance + Σ "
           f"transmittance through composite_hits(peel_topk) launched the "
           f"top-K forward/backward kernels {launches[0]}/{launches[1]} "
           f"times; image vs peel_fused max |diff| {comp_err:.3e} (limit "
           f"{FWD_ATOL:g}); packed-table gradient vs peel_fused per lane "
           f"{pk_err:.2e} of the lane's largest (limit "
           f"{SCENE_GRAD_RTOL:g}); scene gradient vs peel_fused, relative "
           f"L2 / q99 (limit {SCENE_Q99:g}, quats and scales "
           f"{ROT_SCALE_Q99:g}) / max of the field's largest: "
           + ", ".join(f"{k} {l2:.1e}/{q:.1e}/{m:.1e}"
                       for k, (l2, q, m) in grad_errs.items())
           + "; a second run of each path gives every gradient bitwise")
    return launches


def quantile(x, q):
    """The q-quantile (nearest rank) of a tensor of any size
    (``torch.quantile`` refuses more than 2²⁴ elements)."""
    flat = x.flatten()
    return float(flat.kthvalue(max(1, round(q * flat.numel()))).values)


def field_err(got, ref):
    """(relative L2, q99 and max of |got − ref| / max |ref|)."""
    diff = got - ref
    rel = diff.abs() / (ref.abs().max() + 1e-30)
    return (float(diff.norm() / (ref.norm() + 1e-30)),
            quantile(rel, 0.99), float(rel.max()))


def compare_images(label, img, ref):
    """tests/_utils.assert_images_close's statistic; returns (q, max)."""
    diff = (img - ref).abs()
    q = quantile(diff, IMG_Q)
    worst = float(diff.max())
    check(q < IMG_QTOL and worst < IMG_MAXTOL,
          f"{label}: {IMG_Q}-quantile |diff| {q:.2e} (limit {IMG_QTOL:g}), "
          f"max {worst:.2e} (limit {IMG_MAXTOL:g})")
    return q, worst


def cli_argv(ply, res):
    return ["-o", str(ply), "-r", f"{res[0]},{res[1]}", "-d", str(DEPTH),
            "--fov", str(BENCH_POSE["fov"]), "--radius", str(BENCH_POSE["r"]),
            "--theta", str(BENCH_POSE["theta"]),
            "--phi", str(BENCH_POSE["phi"]),
            "--device", "cuda"]


def small_fit(renderer, ply, tmp):
    """``fit --renderer <renderer>`` through the CLI on the small scene;
    returns the printed line and peak device memory (GiB)."""
    import torch

    from rtgs_tpu_torch.__main__ import main as cli

    f = SMALL_FIT
    out = tmp / f"fit_{renderer}.ply"
    argv = ["fit", *cli_argv(ply, f["res"]), "--renderer", renderer,
            "--views", str(f["views"]), "--steps", str(f["steps"]),
            "--from-scratch", "--init-points", str(f["init_points"]),
            "--max-candidates", str(f["max_candidates"]),
            "--output", str(out)]
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(printed):
        cli(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = printed.getvalue().strip()
    m = FIT_LINE.search(line)
    check(m is not None, f"fit --renderer {renderer} printed {line!r}")
    check(math.isfinite(float(m.group(2))) and math.isfinite(
        float(m.group(3))), f"fit --renderer {renderer}: {line!r}")
    check(out.is_file() and out.stat().st_size > 0,
          f"fit --renderer {renderer} wrote no .ply")
    return line, peak


def phase10_oracle(dev, tmp):
    """The oracle through the CLI; returns the 4096-splat scene's path."""
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.render.oracle import render_oracle
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import load_scene, random_scene, save_scene

    ply = tmp / "scene_4k.ply"
    save_scene(ply, random_scene(ORACLE_N, device=dev, **SCENE_4K))
    w, h = ORACLE_RES
    run_quiet(cli, ["render", *cli_argv(ply, ORACLE_RES), "--renderer",
                    "oracle", "--output", str(tmp / "oracle.npy")])
    torch.cuda.synchronize()

    g = load_scene(ply, device=dev)
    cam = bench_camera(ORACLE_RES, dev)
    # Budgets of the whole scene: its wide splats overflow the default
    # global list, and no pair may be dropped from the reference.
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=ORACLE_N,
              max_global=ORACLE_N)
    with torch.inference_mode():
        img_o = render_oracle(g, cam, depth=DEPTH)
        img_k, stats = render_tiled_keys(g, cam, with_stats=True, **kw)
        dropped = int(stats["local_overflow"]) + int(stats["global_overflow"])
        check(dropped == 0, f"the keys render dropped {dropped} pairs")
        check(bool(torch.isfinite(img_o).all()) and float(img_o.max()) > 0.05,
              "oracle image is not finite or black")
        q, worst = compare_images("oracle vs keys", img_o, img_k)
    say(10, f"CLI render --renderer oracle of {g.num} splats at {w}x{h}; in "
            f"process against the keys render: {IMG_Q}-quantile |diff| "
            f"{q:.2e} (limit {IMG_QTOL:g}), max {worst:.2e} (limit "
            f"{IMG_MAXTOL:g})")
    line, peak = small_fit("oracle", ply, tmp)
    say(10, f"CLI fit --renderer oracle, {SMALL_FIT['steps']} steps at "
            f"{SMALL_FIT['res'][0]}x{SMALL_FIT['res'][1]}, "
            f"{SMALL_FIT['views']} views: '{line}'; peak device memory "
            f"{peak:.2f} GiB")
    return ply


def worst_pixel_lists(g, cam, kw, img_t, img_k):
    """The pixel where the ``tiled`` and the keys image differ most, and its
    winners as each renderer lists them: (id, t1, α) a layer."""
    import torch

    from rtgs_tpu_torch.ops.peel import CHUNK, peel_keys
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             intersect_candidates,
                                             pack_features,
                                             precompute_features,
                                             shade_winners_kp)

    diff = (img_t - img_k).abs().amax(-1)                  # (W, H)
    x, y = divmod(int(diff.argmax()), diff.shape[1])
    tw, th = TILE
    nty = -(-cam.buf_size[1] // th)
    t, p = (x // tw) * nty + y // th, (x % tw) * th + y % th
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"], narrow=kw["bin_narrow"],
                        chunk=CHUNK)
    feats = precompute_features(g, cam)
    packed = pack_features(feats)
    cand, pix = b.candidates[t:t + 1], _tile_pixel_features(cam, TILE)[t:t + 1]
    t1_k, sid = peel_keys(packed, cand, pix, DEPTH)
    a_k = shade_winners_kp(packed, sid, pix)[0]
    t1, alpha, _ = intersect_candidates(feats, cand, pix[..., :3])
    t1_s, order = torch.sort(t1[0, p], stable=True)
    order = order[:DEPTH]
    rows = []
    for k in range(DEPTH):
        if not (math.isfinite(float(t1_k[0, k, p]))
                or math.isfinite(float(t1_s[k]))):
            break
        rows.append(
            f"{k}: keys ({int(sid[0, k, p])}, {float(t1_k[0, k, p]):.9g}, "
            f"{float(a_k[0, k, p]):.6g}) tiled ({int(cand[0, order[k]])} in "
            f"slot {int(order[k])}, {float(t1_s[k]):.9g}, "
            f"{float(alpha[0, p, order[k]]):.6g})")
    return (f"pixel ({x}, {y}) = tile {t} pixel {p}, |diff| "
            f"{float(diff[x, y]):.3e}: " + "; ".join(rows))


def phase11_tiled(g100k, ply_4k, dev, tmp):
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.render.tiled import render_tiled, render_tiled_keys
    from rtgs_tpu_torch.scene import load_scene, save_scene

    ply = tmp / "scene_100k.ply"
    save_scene(ply, g100k)
    res = CFG_100K["res"]
    argv = [*cli_argv(ply, res), "--renderer", "tiled", "--max-candidates",
            str(CFG_100K["max_candidates"]), "--bin-narrow",
            str(CFG_100K["bin_narrow"])]
    run_quiet(cli, ["render", *argv, "--output", str(tmp / "tiled.npy")])
    torch.cuda.synchronize()

    g = load_scene(ply, device=dev)
    cam = bench_camera(res, dev)
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=CFG_100K[
        "max_candidates"], max_global=CFG_100K["max_global"],
        bin_narrow=CFG_100K["bin_narrow"])
    with torch.inference_mode():
        img_t = render_tiled(g, cam, **kw)
        img_k = render_tiled_keys(g, cam, **kw)
        check(bool(torch.isfinite(img_t).all()) and float(img_t.max()) > 0.05,
              "tiled image is not finite or black")
        q, worst = compare_images("tiled vs keys", img_t, img_k)
        lists = worst_pixel_lists(g, cam, kw, img_t, img_k)
    say(11, f"CLI render --renderer tiled of {g.num} splats at "
            f"{res[0]}x{res[1]}; in process against the keys render: "
            f"{IMG_Q}-quantile |diff| {q:.2e} (limit {IMG_QTOL:g}), max "
            f"{worst:.2e} (limit {IMG_MAXTOL:g})")
    say(11, f"tiled vs keys, the worst pixel's winners (id, t1, alpha) a "
            f"layer: {lists}")
    line, peak = small_fit("tiled", ply_4k, tmp)
    say(11, f"CLI fit --renderer tiled, {SMALL_FIT['steps']} steps at "
            f"{SMALL_FIT['res'][0]}x{SMALL_FIT['res'][1]} on the "
            f"{ORACLE_N}-splat scene, {SMALL_FIT['views']} views: '{line}'; "
            f"peak device memory {peak:.2f} GiB")

def scene_grads(g, cam, render, **kw):
    """The image and the gradients of Σ image for every scene field."""
    leaves = {f: getattr(g, f).detach().clone().requires_grad_()
              for f in SCENE_FIELDS}
    img = render(type(g)(mask=g.mask, **leaves), cam, depth=DEPTH,
                 tile=TILE, **kw)
    img.sum().backward()
    return img.detach(), {f: x.grad for f, x in leaves.items()}


def phase12_gradients(g, dev):
    """The shade backward against autograd of the plain forward, and the
    keys path's scene gradients against the fused path's, at the fit
    configuration."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.render.tiled import (_shade_forward,
                                             render_tiled_keys,
                                             render_tiled_pallas,
                                             shade_winners_kp)

    cam, packed, cand, counts, lb, pix = keys_inputs(g, CFG_FIT, dev)
    _, sid = peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)
    gen = torch.Generator(device=dev).manual_seed(2)
    cots = [torch.randn(sid.shape, generator=gen, device=dev)
            for _ in range(4)]

    def table_grad(shade):
        leaf = packed.detach().clone().requires_grad_()
        torch.autograd.backward(shade(leaf, sid, pix), cots)
        return leaf.grad

    d_hand, d_auto = table_grad(shade_winners_kp), table_grad(_shade_forward)
    torch.cuda.synchronize()
    check(torch.equal(table_grad(shade_winners_kp), d_hand), "shade "
          "backward: a second run gives another table gradient")
    n = packed.shape[0] - 1
    check(bool(torch.isfinite(d_hand).all()), "shade backward: non-finite")
    check(bool((d_hand[n] == 0).all()), "shade backward: the sentinel row "
          "has a gradient")
    lane = float(((d_hand[:n] - d_auto[:n]).abs().amax(0)
                  / (d_auto[:n].abs().amax(0) + 1e-30)).max())
    check(lane <= BWD_LANE_RTOL, f"shade backward per-lane error {lane} > "
          f"{BWD_LANE_RTOL}")
    vacant = float((sid < 0).float().mean())
    w, h = CFG_FIT["res"]
    say(12, f"shade_winners_kp at 100k@{w}x{h} (T={cand.shape[0]} K={DEPTH} "
            f"P={pix.shape[1]}, vacant {vacant:.2%}): backward vs torch "
            f"autograd of the plain forward, per lane {lane:.3e} of the "
            f"lane's largest (limit {BWD_LANE_RTOL:g}), sentinel row exactly "
            f"0, a second run bitwise the first")
    del d_hand, d_auto, cots

    kw = dict(max_candidates=CFG_FIT["max_candidates"],
              max_global=CFG_FIT["max_global"])
    img_k, gk = scene_grads(g, cam, render_tiled_keys, **kw)
    img_b, gb = scene_grads(g, cam, render_tiled_keys, tile_bands=2, **kw)
    img_p, gp = scene_grads(g, cam, render_tiled_pallas, **kw)
    _, gk2 = scene_grads(g, cam, render_tiled_keys, **kw)
    torch.cuda.synchronize()
    check(torch.equal(img_b, img_k), "banded image differs from unbanded")
    img_err = float((img_k - img_p).abs().max())
    parts = []
    for f in SCENE_FIELDS:
        check(bool(torch.isfinite(gk[f]).all())
              and bool(torch.isfinite(gb[f]).all()),
              f"non-finite keys-path gradient of {f}")
        check(torch.equal(gk2[f], gk[f]), f"keys scene gradient of {f}: a "
              f"second run gives another gradient")
        limit = ROT_SCALE_Q99 if f in ("quats", "scales") else SCENE_Q99
        errs = [field_err(gk[f], gp[f]), field_err(gb[f], gk[f])]
        for label, e in zip(("vs pallas", "banded vs unbanded"), errs):
            check(e[1] <= limit, f"keys scene gradient of {f} {label}: "
                  f"{e} (relative L2, q99, max; q99 limit {limit:g})")
        parts.append(f"{f} " + " ".join(
            f"{e[0]:.1e}/{e[1]:.1e}/{e[2]:.1e}" for e in errs))
    say(12, f"scene gradients of Σ image at 100k@{w}x{h}, keys vs pallas | "
            f"keys in 2 bands vs unbanded, each relative L2 / q99 (limit "
            f"{SCENE_Q99:g}, quats and scales {ROT_SCALE_Q99:g}) / max of "
            f"the field's largest: " + "; ".join(parts) + f"; keys vs a "
            f"second run of itself bitwise; image keys vs pallas max |diff| "
            f"{img_err:.2e}, banded image bitwise the unbanded one; no NaN")


def phase12_bench(cfg, g, dev):
    """The repository's benchmark protocol at one configuration; returns
    the keys kernel's launches of one forward+backward."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.probes._common import BENCH_MAX_GLOBAL
    from rtgs_tpu_torch.render.tiled import render_tiled_keys

    cam = bench_camera(cfg["res"], dev)
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=cfg["max_candidates"],
              max_global=BENCH_MAX_GLOBAL, bin_narrow=cfg["bin_narrow"],
              tile_bands=cfg["tile_bands"])

    peel_keys_cuda.launches = 0
    with torch.no_grad():
        img, stats = render_tiled_keys(g, cam, with_stats=True, **kw)
    fwd_launches = peel_keys_cuda.launches
    stats = {k: int(v) for k, v in stats.items()}
    dropped = stats["local_overflow"] + stats["global_overflow"]
    check(dropped == 0, f"bench {cfg['label']}: {dropped} candidates dropped")
    check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.05,
          f"bench {cfg['label']}: image not finite or black")
    del img
    leaves = {f: getattr(g, f).detach().clone().requires_grad_()
              for f in SCENE_FIELDS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peel_keys_cuda.launches = 0
    render_tiled_keys(type(g)(mask=g.mask, **leaves), cam,
                      **kw).sum().backward()
    torch.cuda.synchronize()
    step_launches = peel_keys_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for f, x in leaves.items():
        check(x.grad is not None and bool(torch.isfinite(x.grad).all()),
              f"bench {cfg['label']}: gradient of {f} missing or non-finite")
    check(float(leaves["means"].grad.abs().max()) > 0,
          f"bench {cfg['label']}: zero gradient")
    bands = cfg["tile_bands"] or 1
    want = 2 * bands if bands > 1 else 1
    check(fwd_launches == bands and step_launches == want,
          f"bench {cfg['label']}: keys kernel launched {fwd_launches} times "
          f"in a forward and {step_launches} in a forward+backward, expected "
          f"{bands} and {want}")
    say(12, f"bench {cfg['label']}, K {DEPTH}, bands {bands}: forward and "
            f"forward+backward of Σ image; binning {stats}, 0 dropped; peak "
            f"device memory of a forward+backward {peak:.2f} GiB; keys "
            f"kernel launches {fwd_launches} a forward, {step_launches} a "
            f"forward+backward")
    return fwd_launches + step_launches


BENCH_LINE = re.compile(r"([\d.]+)M rays/s \(([\d.]+) ms/frame compute")


def phase13_keys_cli(g, tmp):
    """``fit --renderer keys`` and ``bench`` through the CLI; returns the
    keys kernel's launches and segment_rows.cu's (one a band backward)."""
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import (peel_fused_bwd_cuda,
                                         peel_fused_cuda, peel_keys_cuda,
                                         segment_rows_cuda)
    from rtgs_tpu_torch.scene import save_scene

    ply, out = tmp / "scene_100k.ply", tmp / "fit_keys.ply"
    save_scene(ply, g)
    w, h = CFG_FIT["res"]
    common = ["-o", str(ply), "-r", f"{w},{h}", "-d", str(DEPTH),
              "--fov", str(BENCH_POSE["fov"]),
              "--radius", str(BENCH_POSE["r"]),
              "--renderer", "keys", "--max-candidates",
              str(CFG_FIT["max_candidates"]), "--device", g.device.type]
    argv = ["fit", *common, "--views", str(FIT_VIEWS), "--steps",
            str(FIT_CLI_STEPS), "--from-scratch", "--tile-bands",
            str(FIT_CLI_BANDS), "--output", str(out)]
    peel_fused_cuda.launches = peel_fused_bwd_cuda.launches = 0
    peel_keys_cuda.launches = segment_rows_cuda.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli(argv)
    torch.cuda.synchronize()
    fit_launches = peel_keys_cuda.launches
    seg = segment_rows_cuda.launches
    want = FIT_CLI_BANDS * (FIT_VIEWS + 2 * FIT_CLI_STEPS)
    line = printed.getvalue().strip()
    say(13, f"CLI fit --renderer keys ({FIT_VIEWS} views, {FIT_CLI_STEPS} "
            f"steps, {FIT_CLI_BANDS} bands): printed "
            f"'{line}'; keys kernel launches {fit_launches} (expected "
            f"{FIT_CLI_BANDS} x ({FIT_VIEWS} + 2 x {FIT_CLI_STEPS}): every "
            f"step runs each band twice); segment_rows {seg} (expected "
            f"{FIT_CLI_BANDS} x {FIT_CLI_STEPS}: a band backward each); "
            f"fused kernels "
            f"{peel_fused_cuda.launches}/{peel_fused_bwd_cuda.launches}")
    check(fit_launches == want, f"keys kernel launched {fit_launches} times "
          f"in fit --renderer keys, expected {want}")
    check(seg == FIT_CLI_BANDS * FIT_CLI_STEPS, f"segment_rows launched "
          f"{seg} times in fit --renderer keys")
    check(peel_fused_cuda.launches == 0 and peel_fused_bwd_cuda.launches == 0,
          "fit --renderer keys launched the fused kernels")
    m = FIT_LINE.search(line)
    check(m is not None, f"fit --renderer keys printed {line!r}")
    check(math.isfinite(float(m.group(2))) and math.isfinite(
        float(m.group(3))), f"fit --renderer keys: {line!r}")
    check(out.is_file() and out.stat().st_size > 0, "fit wrote no .ply")

    iters = 5
    peel_keys_cuda.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli(["bench", *common, "--theta", str(BENCH_POSE["theta"]), "--phi",
             str(BENCH_POSE["phi"]), "--iters", str(iters)])
    bench_launches = peel_keys_cuda.launches
    line = printed.getvalue().strip()
    frames = 1 + iters + max(iters // 2, 3)
    say(13, f"CLI bench --renderer keys at 100k@{w}x{h}: keys kernel "
            f"launches {bench_launches} (expected {frames}: a warm-up, "
            f"{iters} timed, {max(iters // 2, 3)} with the image read back)")
    m = BENCH_LINE.search(line)
    check(m is not None and float(m.group(1)) > 0,
          f"bench printed {line!r}")
    check(bench_launches == frames, f"keys kernel launched {bench_launches} "
          f"times in bench, expected {frames}")
    return fit_launches + bench_launches, seg


def same_bits(got, ref):
    """Bitwise equality with NaNs at the same places."""
    import torch

    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(got, nan=0.0),
                            torch.nan_to_num(ref, nan=0.0)))


def phase14_kmicro(dev):
    """Every kmicro variant against its plain version at 960x256x128, then
    the probe as a program. Returns its launches."""
    import torch

    from rtgs_tpu_torch.probes import kmicro

    x = kmicro.make_input(960, 256, 128, dev)
    t, _, c = x.shape

    def plain(name, inp):
        return plain_in_bands(lambda xb: kmicro.micro_torch(name, xb), t, inp)

    def compare(name, got, ref):
        if name in ULP_VARIANTS:
            ulp = int((got.view(torch.int32).long()
                       - ref.view(torch.int32).long()).abs().max())
            check(ulp <= 2, f"kmicro {name}: {ulp} ulp from torch")
            return f"{ulp} ulp"
        if name == "matvec_ones":
            rel = float(((got - ref).abs() / ref.abs()).max())
            check(rel <= SUM_RTOL, f"kmicro {name}: relative error {rel}")
            return f"rel {rel:.1e}"
        if name == "chunkbody":
            k = kmicro.K
            qa_g, qa_r = got[..., 2 * k:3 * k], ref[..., 2 * k:3 * k]
            fin = torch.isfinite(qa_r)
            rest = torch.ones(c, dtype=torch.bool, device=dev)
            rest[2 * k:3 * k] = False
            check(same_bits(got[..., rest], ref[..., rest])
                  and torch.equal(fin, torch.isfinite(qa_g))
                  and torch.equal(qa_r.isnan(), qa_g.isnan()),
                  "kmicro chunkbody: slots, t1 or colors differ")
            rel = (float(((qa_g - qa_r)[fin].abs()
                          / (qa_r[fin].abs() + 1e-6)).max())
                   if bool(fin.any()) else 0.0)
            check(rel <= 1e-5, f"kmicro chunkbody: qa off by {rel} (log)")
            return f"bitwise, qa rel {rel:.1e}"
        check(same_bits(got, ref), f"kmicro {name}: differs from the plain "
              f"version at {int((got != ref).sum())} entries")
        return "bitwise"

    for name in kmicro.VARIANTS:
        got = kmicro.micro_cuda(name, x)
        ref = plain(name, x)
        torch.cuda.synchronize()
        verdict = compare(name, got, ref)
        if name == "chunkbody":
            # Uniform positive rows never hit; signed ones do.
            xs = (x - 1.5).contiguous()
            got_s, ref_s = kmicro.micro_cuda(name, xs), plain(name, xs)
            hits = float(torch.isfinite(ref_s[..., :kmicro.K]).float().mean())
            check(hits > 0.05, f"chunkbody: signed rows hit {hits:.2%}")
            verdict += (f"; on signed rows ({hits:.1%} of the layers hit) "
                        + compare(name, got_s, ref_s))
            del xs, got_s, ref_s
        del got, ref
        say(14, f"kmicro {name:18s} {verdict}")
    check_refusals(kmicro, x)
    kmicro.micro_cuda.launches = 0
    run_quiet(kmicro.main, ["--iters", "5"])
    launches = kmicro.micro_cuda.launches
    check(launches == 6 * len(kmicro.VARIANTS), f"kmicro launched "
          f"{launches} kernels, expected {6 * len(kmicro.VARIANTS)}")
    return launches


def check_refusals(kmicro, x):
    """A wrapper raises on what its kernel does not take, and the plain
    version is taken for a CPU tensor only."""
    for bad in (x.cpu(), x.transpose(1, 2), x[:, :64].contiguous()):
        try:
            kmicro.micro_cuda("chunkbody", bad)
        except ValueError:
            continue
        raise SmokeFailure("kmicro took a wrong input")


def phase14_scene_probes(dev):
    """kprobe's and lpprobe's variants against their plain versions at
    100k@640x384 with the budget at which nothing drops, then both probes
    as programs. Returns the two probes' launches."""
    import torch

    from rtgs_tpu_torch.ops.peel import _counts, peel_fused_cuda
    from rtgs_tpu_torch.probes import _common, kprobe, lpprobe

    cfg = CFG_100K
    w, h = cfg["res"]
    packed, cand, lb, pix, binning = _common.scene_tables(
        cfg["n"], w, h, cfg["max_candidates"], cfg["max_global"],
        cfg["bin_narrow"], dev)
    dropped = int(binning.local_overflow) + int(binning.global_overflow)
    check(dropped == 0, f"the probes' scene drops {dropped} candidates")
    counts = _counts(cand)
    t, c = cand.shape
    p = pix.shape[1]
    live = int((cand >= 0).sum())
    rad, trans, slots = peel_fused_cuda(packed, cand, counts, pix, DEPTH)
    prod_ref = torch.cat([rad, trans[:, None]], dim=1)
    winners = int((slots >= 0).sum())

    def plain(name, *qa):
        return plain_in_bands(
            lambda cb, nb, qb: kprobe.ablate_torch(name, packed, cb, nb, qb,
                                                   DEPTH, *qa),
            t, cand, counts, pix)

    for name in kprobe.VARIANTS:
        got = kprobe.ablate_cuda(name, packed, cand, counts, pix, DEPTH)
        torch.cuda.synchronize()
        if name in ("prod", "prod_static"):
            check(torch.equal(got, prod_ref), f"kprobe {name} differs from "
                  f"peel_fused_cuda")
            say(14, f"kprobe {name:13s} bitwise peel_fused_cuda's radiance "
                    f"and transmittance")
            continue
        ref = plain(name)
        check(same_bits(got, ref), f"kprobe {name}: differs from the plain "
              f"version at {int((got != ref).sum())} entries")
        hit = float(torch.isfinite(ref[:, 0]).float().mean())
        say(14, f"kprobe {name:13s} bitwise the plain version (channel 0 "
                f"finite on {hit:.1%} of the pixels)")
        del got, ref
    # The shade variants' result above is intersect's whatever they shade
    # (their channel 1 starts at −inf). With +inf for the initial state and
    # for a missed candidate it is the minimum of their shading terms: held
    # here against the plain minimum of the same terms, which runs the same
    # IEEE operations in the same order (--fmad=false). Only logf against
    # torch.log may differ (2 ulp), which the last sum rounds into at most
    # an ulp of the result: SHADE_TOL of max(1, |result|).
    for name in kprobe.SHADE_VARIANTS:
        got = kprobe.ablate_cuda(name, packed, cand, counts, pix, DEPTH,
                                 math.inf, math.inf)
        ref = plain(name, math.inf, math.inf)
        torch.cuda.synchronize()
        rest = [0, 2, 3]
        fin = torch.isfinite(ref[:, 1])
        check(same_bits(got[:, rest], ref[:, rest])
              and torch.equal(fin, torch.isfinite(got[:, 1]))
              and not bool(torch.isnan(got[:, 1]).any()),
              f"kprobe {name} (+inf state): t1 or the hit pattern differs")
        diff = ((got[:, 1] - ref[:, 1]).abs()
                / ref[:, 1].abs().clamp(min=1.0))[fin]
        limit = SHADE_TOL
        check(bool(fin.any()) and float(diff.max()) <= limit,
              f"kprobe {name} (+inf state): shading off by "
              f"{float(diff.max())} > {limit} of max(1, |result|)")
        say(14, f"kprobe {name:13s} with a +inf state: the minimum of its "
                f"shading terms, finite on {float(fin.float().mean()):.1%} "
                f"of the pixels, max |diff| {float(diff.max()):.2e} from the "
                f"plain version (limit {limit:.2e}; bitwise on "
                f"{float((diff == 0).float().mean()):.2%})")
        del got, ref
    say(14, f"kprobe scene: T={t} C={c} P={p}, {live} live pairs, {winners} "
            f"winners, 0 dropped")

    outs = {tag: fn() for tag, fn in
            lpprobe.keys_forms(packed, cand, lb, pix, DEPTH).items()}
    agree = lpprobe.forms_agree(outs)
    check(all(agree.values()), f"keys forms differ: {agree}")
    del outs
    for name in lpprobe.FLOOR_VARIANTS:
        got = lpprobe.floor_cuda(name, packed, cand, p, DEPTH)
        ref = lpprobe.floor_torch(name, packed, cand, p, DEPTH)
        torch.cuda.synchronize()
        if name == "nothing":
            check(torch.equal(got, ref), "floor nothing is not +inf")
            verdict = "bitwise"
        else:
            rel = float(((got - ref).abs() / ref.abs()).max())
            check(rel <= SUM_RTOL, f"floor touch: relative error {rel} > "
                  f"{SUM_RTOL} (f32 sums of {c} terms in another order)")
            verdict = f"rel {rel:.1e} (limit {SUM_RTOL:g})"
        say(14, f"lpprobe floor {name:8s} {verdict}")
    say(14, "lpprobe: the keys kernel's four forms agree bitwise")

    argv = [str(cfg["n"]), str(w), str(h), "--cand",
            str(cfg["max_candidates"]), "--glob", str(cfg["max_global"]),
            "--narrow", str(cfg["bin_narrow"])]
    kprobe.ablate_cuda.launches = 0
    run_quiet(kprobe.main, [*argv, "--variants", ",".join(kprobe.VARIANTS),
                            "--iters", "8"])
    abl_launches = kprobe.ablate_cuda.launches
    check(abl_launches == 9 * len(kprobe.KERNEL_VARIANTS),
          f"kprobe launched {abl_launches} ablation kernels")
    lpprobe.floor_cuda.launches = 0
    run_quiet(lpprobe.main, [*argv, "--iters", "7"])
    flo_launches = lpprobe.floor_cuda.launches
    # 6 timed lines of 8 calls, and the host-time table's warm-up and
    # rounds of the whole wrapper call.
    want = 8 * 6 + 1 + lpprobe.HOST_ROUNDS * lpprobe.HOST_CALLS
    check(flo_launches == want, f"lpprobe launched {flo_launches} floor "
          f"kernels through its wrapper, expected {want}")
    return abl_launches, flo_launches


def http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read()


def http_post(port, ev):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/event",
                                 data=json.dumps(ev).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status


def phase15_serve(g, dev):
    """The viewer over HTTP on the 1M scene at 1920x1088, then the
    progressive sampler; returns the keys kernel's launches."""
    import argparse
    import threading

    import torch

    from rtgs_tpu_torch.camera import image_to_display
    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.render.api import (ProgressiveSampler, render,
                                           render_progressive)
    from rtgs_tpu_torch.utils.image import decode_png, to_uint8
    from rtgs_tpu_torch.viewer.server import make_server

    w, h = FULL_RES
    args = argparse.Namespace(res=FULL_RES, fov=BENCH_POSE["fov"], depth=DEPTH,
                              renderer="keys", radius=BENCH_POSE["r"], port=0)
    # What ``serve`` runs: make_server, then serve_forever (here in a
    # daemon thread, shut down at the end).
    server, session = make_server(g, args, render_kwargs=SERVE_KW)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    launches = 0
    try:
        page = http_get(port, "/")
        check(b"rtgs-tpu viewer" in page, "serve: / lacks the page title")

        def frame(label):
            nonlocal launches
            peel_keys_cuda.launches = 0
            png = http_get(port, "/frame")
            n = peel_keys_cuda.launches
            launches += n
            say(15, f"GET /frame ({label}): {len(png)} bytes; keys launches "
                    f"{n}")
            return png, n

        png, n = frame("first pose")
        check(n == BANDS, f"serve: a fresh frame launched the keys kernel "
              f"{n} times, expected {BANDS}")
        with torch.inference_mode():
            ref = render(g, session.camera(), depth=DEPTH, renderer="keys",
                         **SERVE_KW)
            ref8 = to_uint8(image_to_display(ref).cpu().numpy())
        got = decode_png(png)
        check(got.shape == (h, w, 3) and bool((got == ref8).all()),
              f"serve: the PNG frame (shape {got.shape}) is not bitwise "
              f"the in-process render")
        again, n = frame("same pose, cached")
        check(n == 0 and again == png, f"serve: a repeated frame launched "
              f"{n} keys kernels or changed")
        seen = png
        for ev in SERVE_EVENTS:
            status = http_post(port, ev)
            check(status == 204, f"serve: /event {ev} answered {status}")
            nxt, n = frame(f"after {ev['type']}")
            check(n == BANDS and nxt != seen,
                  f"serve: {ev['type']} gave an unchanged frame or {n} keys "
                  f"launches")
            seen = nxt
        say(15, f"serve on 1M@{w}x{h} ({BANDS} bands): / has the title, "
                f"/frame bitwise the in-process render, a cached frame "
                f"renders nothing, pan, zoom and rot each give a new frame")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "serve: the server thread did not stop")

    cam = bench_camera(FULL_RES, dev)
    peel_keys_cuda.launches = 0
    with torch.inference_mode():
        s = ProgressiveSampler(g, cam, depth=DEPTH, renderer="keys",
                               jitter=True,
                               generator=torch.Generator().manual_seed(3),
                               **SERVE_KW)
        for _ in range(PROGRESSIVE_SAMPLES):
            s.sample()
        launches += peel_keys_cuda.launches
        ref = render_progressive(g, cam, depth=DEPTH,
                                 samples=PROGRESSIVE_SAMPLES, renderer="keys",
                                 jitter=True,
                                 generator=torch.Generator().manual_seed(3),
                                 **SERVE_KW)
        jitter_equal = torch.equal(s.display(), ref)
        peel_keys_cuda.launches = 0
        s = ProgressiveSampler(g, cam, depth=DEPTH, renderer="keys",
                               **SERVE_KW)
        for _ in range(PROGRESSIVE_SAMPLES):
            s.sample()
        launches += peel_keys_cuda.launches
        one = render(g, cam, depth=DEPTH, renderer="keys", **SERVE_KW)
        plain_equal = torch.equal(s.display(), one)
    check(jitter_equal, "ProgressiveSampler with jitter differs from "
          "render_progressive with a generator of the same seed")
    check(plain_equal, "ProgressiveSampler without jitter differs from one "
          "render")
    say(15, f"ProgressiveSampler, {PROGRESSIVE_SAMPLES} samples at 1M@"
            f"{w}x{h}: jittered equal to render_progressive(jitter=True) of "
            f"the same seed, unjittered bitwise one render")
    return launches


def phase16_ring(g1m, g100k, g4k, dev):
    """The ring renderer on a 1x1 mesh: one rank, one NCCL group on the
    card (NCCL refuses two ranks on one device, so one card holds no larger
    mesh), and the sharded training step on it; returns the launches of
    the keys kernel and of segment_rows.cu on the ring's main path."""
    import torch
    import torch.distributed as dist

    from rtgs_tpu_torch.camera import generate_ray_grid
    from rtgs_tpu_torch.ops.peel import peel_keys_cuda, segment_rows_cuda
    from rtgs_tpu_torch.parallel.mesh import (initialize_distributed,
                                              make_mesh)
    from rtgs_tpu_torch.parallel.render import (render_sharded,
                                                render_tiled_sharded,
                                                shard_scene)
    from rtgs_tpu_torch.probes.ring import step_comparison
    from rtgs_tpu_torch.render.oracle import composite_rays
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import random_scene

    w, h = FULL_RES
    kw = dict(max_candidates=3584, max_global=64, bin_narrow=4)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device="cuda")
        try:
            mesh = make_mesh(1, 1, device="cuda")
            shard = shard_scene(g1m, mesh)
            cam = bench_camera(FULL_RES, dev)
            with torch.inference_mode():
                peel_keys_cuda.launches = 0
                img = render_tiled_sharded(shard, cam, mesh, depth=DEPTH,
                                           **kw)
                torch.cuda.synchronize()
                launches = peel_keys_cuda.launches
                ref = render_tiled_keys(g1m, cam, depth=DEPTH,
                                        tile_bands=BANDS, **kw)
                err = float((img - ref).abs().max())
                same = torch.equal(img, ref)
            check(launches == mesh.n_prims, f"ring: {launches} keys "
                  f"launches in a {mesh.n_prims}-step ring")
            check(bool(torch.isfinite(img).all()) and same,
                  f"ring 1M@{w}x{h}: not bitwise render_tiled_keys (max "
                  f"|diff| {err})")
            say(16, f"render_tiled_sharded on a 1x1 NCCL mesh (one card: "
                    f"NCCL refuses two ranks on one device, so no larger "
                    f"mesh), 1M@{w}x{h}: bitwise render_tiled_keys in "
                    f"{BANDS} bands; keys launches {launches} (one a ring "
                    f"step)")

            wf, hf = CFG_FIT["res"]
            cam = bench_camera(CFG_FIT["res"], dev)
            fkw = dict(max_candidates=CFG_FIT["max_candidates"],
                       max_global=CFG_FIT["max_global"])

            def ring_grads():
                leaves = {f: getattr(g100k, f).detach().clone()
                          .requires_grad_() for f in SCENE_FIELDS}
                img = render_tiled_sharded(
                    shard_scene(type(g100k)(mask=g100k.mask, **leaves),
                                mesh), cam, mesh, depth=DEPTH, **fkw)
                (img ** 2).sum().backward()
                return {f: x.grad for f, x in leaves.items()}

            # The shade backward sums by splat in a fixed order
            # (segment_rows.cu), so no deterministic mode is asked for.
            check(not torch.are_deterministic_algorithms_enabled(),
                  "torch's deterministic mode is on")
            peel_keys_cuda.launches = 0
            segment_rows_cuda.launches = 0
            ring = ring_grads()
            torch.cuda.synchronize()
            launches += peel_keys_cuda.launches
            seg_launches = segment_rows_cuda.launches
            check(seg_launches == 1, f"ring backward: {seg_launches} "
                  f"segment_rows launches (one expected: the owner's sum)")
            ring2 = ring_grads()
            ref_leaves = {f: getattr(g100k, f).detach().clone()
                          .requires_grad_() for f in SCENE_FIELDS}
            ref = render_tiled_keys(type(g100k)(mask=g100k.mask,
                                                **ref_leaves),
                                    cam, depth=DEPTH, **fkw)
            (ref ** 2).sum().backward()
            torch.cuda.synchronize()
            for f in SCENE_FIELDS:
                got, want = ring[f], ref_leaves[f].grad
                check(bool(torch.isfinite(got).all()),
                      f"ring gradient of {f} has NaN or inf")
                check(torch.equal(ring2[f], got), f"ring gradient of {f}: "
                      f"a second run gives another gradient")
                check(torch.equal(got, want), f"ring gradient of {f}: not "
                      f"bitwise render_tiled_keys's: {field_err(got, want)} "
                      f"(relative L2, q99, max of the field's largest)")
            say(16, f"scene gradients of Σ image² through the ring at 100k@"
                    f"{wf}x{hf} (torch's deterministic mode off): a second "
                    f"run bitwise the first, and all six fields "
                    f"({', '.join(SCENE_FIELDS)}) bitwise the unbanded "
                    f"render_tiled_keys'; no NaN; launches: keys "
                    f"{launches - mesh.n_prims}, segment_rows {seg_launches}")

            for label, n, res, depth, budgets in (
                    (f"the fit cell, 100k@{wf}x{hf}", g100k.num,
                     CFG_FIT["res"], DEPTH, fkw),
                    (f"the JAX dry run's full scale, 100k@"
                     f"{DRY_RES[0]}x{DRY_RES[1]}", DRY_N, DRY_RES, DRY_DEPTH,
                     DRY_BUDGETS)):
                g = g100k if n == g100k.num else random_scene(
                    n, device=dev, **BENCH_SCENE)
                cam = bench_camera(res, dev)
                with torch.inference_mode():
                    _, stats = render_tiled_keys(g, cam, depth=depth,
                                                 with_stats=True, **budgets)
                dropped = int(stats["local_overflow"]
                              + stats["global_overflow"])
                gen = torch.Generator(device="cpu").manual_seed(1)
                target = torch.rand(res + (3,), generator=gen).to(dev)
                out = step_comparison(g, cam, target, mesh, RING_STEPS,
                                      depth, budgets)
                launches += out["ring_launches"]["peel_keys_cuda"]
                seg_launches += out["ring_launches"]["segment_rows_cuda"]
                check(not out["differ"], f"sharded step at {label}: "
                      f"{RING_STEPS} steps differ from the one-card keys "
                      f"steps in {', '.join(out['differ'])}")
                check(all(math.isfinite(x) for x in out["loss"]),
                      f"sharded step at {label}: loss not finite")
                say(16, f"make_sharded_train_step on the 1x1 mesh at "
                        f"{label}, depth {depth}, budgets "
                        f"{budgets['max_candidates']} / "
                        f"{budgets['max_global']} ({dropped} pairs dropped, "
                        f"the same on both sides: on one rank the shard is "
                        f"the scene): {RING_STEPS} steps "
                        f"bitwise {RING_STEPS} one-card "
                        f"make_train_step(renderer='keys') steps "
                        f"(parameters, Adam moments, losses); loss "
                        + ", ".join(f"{x:.6f}" for x in out["loss"])
                        + f"; launches on the sharded steps: keys "
                          f"{out['ring_launches']['peel_keys_cuda']}, "
                          f"segment_rows "
                          f"{out['ring_launches']['segment_rows_cuda']}")
                del g

            cam = bench_camera(RING_ORACLE_RES, dev)
            rays = generate_ray_grid(cam).reshape(-1)
            with torch.inference_mode():
                rad, trans = render_sharded(shard_scene(g4k, mesh), rays,
                                            DEPTH, mesh)
                ref_rad, ref_trans = composite_rays(g4k, rays, DEPTH)
            err = max(float((rad - ref_rad).abs().max()),
                      float((trans - ref_trans).abs().max()))
            check(err <= FWD_ATOL, f"render_sharded: max |diff| {err} "
                  f"against composite_rays (limit {FWD_ATOL:g})")
            say(16, f"render_sharded (the oracle ring) on the {g4k.num}-"
                    f"splat scene at {RING_ORACLE_RES[0]}x"
                    f"{RING_ORACLE_RES[1]}: max |diff| {err:.1e} against "
                    f"composite_rays (limit {FWD_ATOL:g})")
        finally:
            dist.destroy_process_group()
    return launches, seg_launches


def bvh_rays(dev):
    """Seeded origins on a sphere of radius BVH_RADIUS, aimed at the
    origin."""
    import numpy as np

    from rtgs_tpu_torch.rays import new_rays

    rng = np.random.default_rng(17)
    u = rng.standard_normal((BVH_RAYS, 3))
    origins = BVH_RADIUS * u / np.linalg.norm(u, axis=-1, keepdims=True)
    dirs = -origins / BVH_RADIUS
    return new_rays(origins.astype(np.float32), dirs.astype(np.float32),
                    device=dev)


def bvh_brute(g, rays):
    """Per ray the nearest accepted t1 over all splats, its index (-1 for
    a miss) and the second-nearest t1 (ties), in chunks of rays."""
    import torch

    from rtgs_tpu_torch import gaussians as G

    cov_inv = G.inv_covariance(g.quats, g.scales)[None]
    means, live = g.means[None], g.mask[None] > 0
    best, idx, second = [], [], []
    for s in range(0, rays.origins.shape[0], BVH_BRUTE_CHUNK):
        o = rays.origins[s:s + BVH_BRUTE_CHUNK, None]
        d = rays.directions[s:s + BVH_BRUTE_CHUNK, None]
        t1, _ = G.hit(cov_inv, means, o, d)
        ok = ((t1 > rays.starts[s:s + BVH_BRUTE_CHUNK, None])
              & (t1 < rays.ends[s:s + BVH_BRUTE_CHUNK, None]) & live)
        t1 = torch.where(ok, t1, math.inf)
        two = torch.topk(t1, 2, dim=1, largest=False)
        best.append(two.values[:, 0])
        second.append(two.values[:, 1])
        idx.append(torch.where(torch.isfinite(two.values[:, 0]),
                               two.indices[:, 0], -1))
    return torch.cat(best), torch.cat(idx), torch.cat(second)


def phase17_bvh_profiling(g1m, g100k, dev):
    """The LBVH on the 1M scene (build and queries, against brute force),
    and one torch.profiler trace of a keys render."""
    import torch

    from rtgs_tpu_torch.bvh import build_lbvh, bvh_hit
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.utils.profiling import trace

    n = g1m.num
    bvh = build_lbvh(g1m.means, g1m.quats, g1m.scales, g1m.mask)
    leaves = torch.sort(bvh.prim[n - 1:]).values
    parents = torch.bincount(torch.cat([bvh.left[:n - 1],
                                        bvh.right[:n - 1]]),
                             minlength=2 * n - 1)
    check(torch.equal(leaves, torch.arange(n, device=dev))
          and int(parents[0]) == 0 and bool((parents[1:] == 1).all()),
          "LBVH: the leaves are not a permutation or a node has not one "
          "parent")
    rays = bvh_rays(dev)
    hit = bvh_hit(bvh, g1m, rays, BVH_MAX_STEPS)
    t1_b, idx_b, second = bvh_brute(g1m, rays)
    cut = hit.steps >= BVH_MAX_STEPS
    done = ~cut
    tie = (second - t1_b) <= BVH_TIE_RTOL * t1_b.abs()
    same = (hit.gaussian_idx == idx_b) | tie
    hit_b = idx_b >= 0
    rel = ((hit.t1 - t1_b).abs() / t1_b.abs())[done & hit_b]
    check(bool(same[done].all()), f"LBVH: {int((~same & done).sum())} "
          f"uncut rays name another splat than brute force (not a tie)")
    check(bool((hit.gaussian_idx[done & ~hit_b] == -1).all()),
          "LBVH: an uncut ray hits where brute force misses")
    check(rel.numel() == 0 or float(rel.max()) <= BVH_T1_RTOL,
          f"LBVH: t1 of uncut rays off by {float(rel.max())} relative "
          f"(limit {BVH_T1_RTOL:g})")
    nearer = (hit.t1 < t1_b * (1 - BVH_T1_RTOL)) & cut
    check(not bool(nearer.any()), f"LBVH: {int(nearer.sum())} cut rays "
          f"report a t1 nearer than the true nearest")
    steps = hit.steps.float()
    say(17, f"LBVH of the {n}-splat scene: its leaves a permutation, every "
            f"node but the root one parent; bvh_hit of {BVH_RAYS} rays from "
            f"a sphere of radius {BVH_RADIUS:g} at max_steps "
            f"{BVH_MAX_STEPS}: {int(cut.sum())} rays reach max_steps; steps "
            f"median {float(steps.median()):.0f}, max {int(steps.max())}; "
            f"{int(done.sum())} uncut rays agree with brute force "
            f"({int((done & hit_b).sum())} hits, "
            f"{int((done & tie & (hit.gaussian_idx != idx_b)).sum())} ties "
            f"by another index, t1 max relative error "
            f"{float(rel.max()) if rel.numel() else 0.0:.1e}); no cut ray "
            f"reports a nearer t1")

    cam = bench_camera(CFG_100K["res"], dev)
    kw = dict(depth=DEPTH, tile=TILE, max_candidates=CFG_100K["max_candidates"],
              max_global=CFG_100K["max_global"],
              bin_narrow=CFG_100K["bin_narrow"])
    with torch.inference_mode():
        render_tiled_keys(g100k, cam, **kw)     # warm-up outside the trace
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as logdir:
                render_tiled_keys(g100k, cam, **kw)
            path = pathlib.Path(logdir) / "trace.json"
            events = json.loads(path.read_text())["traceEvents"]
            size = path.stat().st_size
    kernels = [e for e in events if e.get("cat") == "kernel"]
    keys = [e for e in kernels if "keys_sid_kernel" in e.get("name", "")]
    check(keys, f"trace: no keys_sid_kernel among {len(kernels)} device "
          f"kernels")
    say(17, f"utils.profiling.trace around a 100k@{cam.buf_size[0]}x"
            f"{cam.buf_size[1]} keys render: Chrome trace of {size} bytes, "
            f"{len(kernels)} device kernels, {len(keys)} of them "
            f"keys_sid_kernel")


def segment_bound(m, n):
    """segment_rows.cu's bound: M rows of 64 f32 and their ids read once,
    n rows written once, against one f32 add a lane and input row."""
    return bound((m + n) * 64 * 4 + 4 * m, f32_ops=64 * m)


def phase18_segment_case(label, g, cfg, dev):
    """segment_rows.cu on the card's inputs at one configuration: the fused
    backward's pair rows (its stage 1) and the keys path's winners (their
    ids, as the shade backward lists them, with random rows), against
    segment_rows_torch on the CPU and against a second launch; then the
    fused, top-K and keys backwards, each twice, bitwise."""
    import torch

    from rtgs_tpu_torch.ops.peel import (peel_fused_bwd_cuda,
                                         peel_fused_cuda, peel_keys_cuda,
                                         peel_topk_bwd_cuda,
                                         segment_rows_cuda,
                                         segment_rows_torch)
    from rtgs_tpu_torch.render.tiled import shade_winners_kp

    _, packed, cand, counts, lb, pix = keys_inputs(g, cfg, dev)
    n = packed.shape[0]
    t, p = cand.shape[0], pix.shape[1]
    _, _, sl = peel_fused_cuda(packed, cand, counts, pix, DEPTH)
    _, sid = peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)
    gen = torch.Generator(device=dev).manual_seed(4)
    g_rad = torch.randn((t, 3, p), generator=gen, device=dev)
    g_tr = torch.randn((t, p), generator=gen, device=dev)
    g_lay = torch.randn((t, 4, DEPTH, p), generator=gen, device=dev)
    cots = [torch.randn(sid.shape, generator=gen, device=dev)
            for _ in range(4)]
    ids_w = sid[sid >= 0].contiguous()
    inputs = {
        "pair rows": peel_fused_bwd_cuda(packed, cand, counts, pix, sl, g_rad,
                                         g_tr, DEPTH, table=False),
        "winner rows": (torch.randn((ids_w.shape[0], 64), generator=gen,
                                    device=dev), ids_w)}
    parts = []
    for what, (rows, ids) in inputs.items():
        got = segment_rows_cuda(rows, ids, n)
        check(torch.equal(segment_rows_cuda(rows, ids, n), got),
              f"{label} {what}: a second segment_rows launch differs")
        rows_c, ids_c = rows.cpu(), ids.cpu()
        want = segment_rows_torch(rows_c, ids_c, n)
        mag = segment_rows_torch(rows_c.abs(), ids_c, n)
        diff = (got.cpu() - want).abs()
        n_diff = int((diff > 0).any(1).sum())
        check(bool((diff <= 1e-6 * mag).all()), f"{label} {what}: "
              f"segment_rows.cu against its CPU twin: {n_diff} rows differ, "
              f"max |diff| {float(diff.max())}")
        parts.append(
            f"{what} M={rows.shape[0]} into N+1={n}: "
            + ("bitwise the CPU twin" if n_diff == 0 else
               f"{n_diff} rows off the CPU twin, max |diff| "
               f"{float(diff.max()):.1e} (within 1e-6 of Σ|rows|)"))
    del inputs, rows, ids

    def keys_bwd():
        leaf = packed.detach().clone().requires_grad_()
        torch.autograd.backward(shade_winners_kp(leaf, sid, pix), cots)
        return leaf.grad

    runs = {
        "fused": lambda: peel_fused_bwd_cuda(packed, cand, counts, pix, sl,
                                             g_rad, g_tr, DEPTH),
        "top-K": lambda: peel_topk_bwd_cuda(packed, cand, counts, pix, sl,
                                            g_lay, DEPTH),
        "keys": keys_bwd}
    for name, fn in runs.items():
        first = fn()
        check(torch.equal(fn(), first), f"{label}: the {name} backward "
              f"gives another table gradient on a second run")
        check(bool((first[-1] == 0).all()), f"{label}: the {name} "
              f"backward's sentinel row is not 0")
    say(18, f"{label}: segment_rows.cu, " + "; ".join(parts)
            + f"; the fused, top-K and keys backwards ({t} tiles, K "
            f"{DEPTH}) each twice: bitwise equal")


def phase18_segment_shapes(dev):
    """segment_rows.cu at the four shapes its callers give it
    (``probes.ktime.segment_inputs``: (a) the fit configuration's pair
    rows, (b) its keys winner rows, (c) 1M@256x192's pair rows, (d) the
    busiest of 8 bands of the 1M@1920x1088 keys backward's winner rows):
    bitwise its CPU twin and a second launch, and every row no id names
    +0.0."""
    import torch

    from rtgs_tpu_torch.ops.peel import segment_rows_cuda, segment_rows_torch
    from rtgs_tpu_torch.probes import ktime

    for label, (rows, ids, n) in ktime.segment_inputs(dev).items():
        got = segment_rows_cuda(rows, ids, n)
        check(torch.equal(segment_rows_cuda(rows, ids, n), got),
              f"segment {label}: a second launch differs")
        want = segment_rows_torch(rows.cpu(), ids.cpu(), n)
        n_diff = int((got.cpu() != want).any(1).sum())
        check(n_diff == 0, f"segment {label}: {n_diff} rows differ from "
              f"the CPU twin")
        keep = ids[(ids >= 0) & (ids < n)].long()
        named = torch.bincount(keep, minlength=n) > 0
        unnamed = got[~named]
        check(bool((unnamed == 0).all()) and not torch.signbit(unnamed).any(),
              f"segment {label}: a row no id names is not +0.0")
        say(18, f"segment {label}: M={rows.shape[0]} into N+1={n}, bitwise "
                f"the CPU twin and a second launch; the {int((~named).sum())} "
                f"rows no id names +0.0")
        del rows, ids, got, want


def fit_views(g, renderer, depth, cfg):
    """FIT_VIEWS orbit views of ``g`` at ``cfg``'s resolution and budgets,
    rendered through ``renderer`` at ``depth``."""
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset

    return synthetic_orbit_dataset(g, FIT_VIEWS, cfg["res"],
                                   fov=BENCH_POSE["fov"],
                                   radius=BENCH_POSE["r"], depth=depth,
                                   renderer=renderer,
                                   **fit_render_kwargs(cfg))


def train_twice(g, renderer, depth=DEPTH, cfg=CFG_FIT, ds=None,
                densify=True):
    """Phase 8's re-fit cut to FIT_CLI_STEPS steps (a density-control pass
    half way, unless not ``densify``), twice from the same state through
    ``renderer`` at ``depth``, on ``ds`` (else :func:`fit_views` at
    ``cfg``); every parameter, the mask and every step's loss and PSNR must be
    bitwise equal. Returns the first and the last step's PSNR and the live
    splats."""
    import torch

    ds = fit_views(g, renderer, depth, cfg) if ds is None else ds
    runs = []
    for _ in range(2):
        solver = refit_solver(g, ds, renderer, FIT_CLI_STEPS, depth=depth,
                              budgets=cfg, densify=densify)
        log = [solver.train_step() for _ in range(FIT_CLI_STEPS)]
        runs.append((solver.params, solver.mask, log))
    (pa, ma, la), (pb, mb, lb) = runs
    check(la == lb, f"{renderer}: the two fits logged other losses or PSNR")
    check(torch.equal(ma, mb), f"{renderer}: the two fits keep other splats")
    for name, a, b in zip(pa._fields, pa, pb):
        check(torch.equal(a, b), f"{renderer}: the two fits end with another "
              f"{name}")
    return la[0]["psnr"], lb[-1]["psnr"], int(mb.sum())


def grads_twice(render, g, cam, **kw):
    """The scene gradient of Σ image through ``render``, twice; the fields
    whose two gradients are not bitwise equal."""
    import torch

    def once():
        leaves = {f: getattr(g, f).detach().clone().requires_grad_()
                  for f in SCENE_FIELDS}
        render(type(g)(mask=g.mask, **leaves), cam, depth=DEPTH,
               **kw).sum().backward()
        return {f: x.grad for f, x in leaves.items()}

    a, b = once(), once()
    torch.cuda.synchronize()
    return [f for f in SCENE_FIELDS if not torch.equal(a[f], b[f])]


def torch_scatter_repeats(dev):
    """Whether the two scatters torch autograd runs in the secondary
    renderers' backwards repeat bitwise on the card: the backward of an
    advanced index with repeated ids (index_put_ with accumulation; the
    splats' features gathered per tile in ``intersect_candidates``) and of
    ``gather`` (scatter_add_; the picks of ``peel_block`` and the oracle's
    top-K)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    src = torch.randn((4096, 64), generator=gen, device=dev)
    idx = torch.randint(0, 4096, (1 << 20,), generator=gen, device=dev)
    cot = torch.randn((1 << 20, 64), generator=gen, device=dev)
    gidx = torch.randint(0, 64, (1 << 14, 64), generator=gen, device=dev)
    gcot = torch.randn((1 << 14, 64), generator=gen, device=dev)

    def index_bwd():
        x = src.clone().requires_grad_()
        (x[idx] * cot).sum().backward()
        return x.grad

    def gather_bwd():
        x = torch.randn((1 << 14, 64), device=dev).requires_grad_()
        (x.gather(1, gidx) * gcot).sum().backward()
        return x.grad

    return {name: torch.equal(fn(), fn()) for name, fn in (
        ("index backward (index_put_ accumulate)", index_bwd),
        ("gather backward (scatter_add_)", gather_bwd))}


def phase18_determinism(g100k, g1m, g4k, dev):
    """Every backward of the port twice, bitwise, with torch's deterministic
    mode off."""
    import torch

    from rtgs_tpu_torch.ops.peel import segment_rows_cuda
    from rtgs_tpu_torch.probes._common import BENCH_MAX_GLOBAL
    from rtgs_tpu_torch.render.oracle import render_oracle
    from rtgs_tpu_torch.render.tiled import render_tiled, render_tiled_keys

    check(not torch.are_deterministic_algorithms_enabled(),
          "torch's deterministic mode is on")
    w, h = CFG_FIT["res"]
    phase18_segment_case(f"100k@{w}x{h}", g100k, CFG_FIT, dev)
    phase18_segment_case("1M@256x192", g1m, CFG_1M_GATE, dev)
    phase18_segment_shapes(dev)

    wf, hf = FULL_RES
    kw = dict(max_candidates=3584, max_global=BENCH_MAX_GLOBAL, bin_narrow=4,
              tile_bands=BANDS)
    cam = bench_camera(FULL_RES, dev)
    segment_rows_cuda.launches = 0
    img_a, ga = scene_grads(g1m, cam, render_tiled_keys, **kw)
    torch.cuda.synchronize()
    launches = segment_rows_cuda.launches
    img_b, gb = scene_grads(g1m, cam, render_tiled_keys, **kw)
    torch.cuda.synchronize()
    check(torch.equal(img_a, img_b), "keys 1M image differs between runs")
    for f in SCENE_FIELDS:
        check(torch.equal(ga[f], gb[f]), f"keys 1M@{wf}x{hf}: a second "
              f"forward+backward gives another gradient of {f}")
    check(launches == BANDS, f"segment_rows launched {launches} times in a "
          f"{BANDS}-band backward")
    del ga, gb, img_a, img_b
    say(18, f"keys path forward+backward of Σ image at 1M@{wf}x{hf} in "
            f"{BANDS} bands, twice: image and every scene gradient bitwise "
            f"equal; segment_rows launched {launches} times a backward (one "
            f"a band)")

    fits = {r: train_twice(g100k, r) for r in ("pallas", "keys")}
    say(18, f"{FIT_CLI_STEPS} training steps at 100k@{w}x{h} ({FIT_VIEWS} "
            f"views, a density-control pass at step {FIT_CLI_STEPS // 2}), "
            f"twice from the same state: "
            + "; ".join(f"{r}: every parameter, the mask and every step's "
                        f"loss and PSNR bitwise equal (PSNR {first:.4f} -> "
                        f"{last:.4f} dB, {live} live)"
                        for r, (first, last, live) in fits.items()))

    cam_o = bench_camera(SMALL_FIT["res"], dev)
    cam_t = bench_camera(CFG_FIT["res"], dev)
    secondary = {
        f"oracle ({g4k.num} splats at {SMALL_FIT['res'][0]}x"
        f"{SMALL_FIT['res'][1]})": grads_twice(
            lambda s, c, depth: render_oracle(s, c, depth=depth), g4k,
            cam_o),
        f"tiled (100k@{w}x{h})": grads_twice(
            render_tiled, g100k, cam_t, tile=TILE,
            max_candidates=CFG_FIT["max_candidates"],
            max_global=CFG_FIT["max_global"])}
    scatters = torch_scatter_repeats(dev)
    say(18, "plain torch autograd renderers, scene gradient twice: "
            + "; ".join(f"{k}: " + ("bitwise equal" if not v else
                                    f"{', '.join(v)} differ")
                        for k, v in secondary.items())
            + "; torch's own scatters on the card, twice: "
            + "; ".join(f"{k} {'bitwise' if v else 'NOT bitwise'}"
                        for k, v in scatters.items()))


def keys_passes(packed, cand, counts, lb, pix, depths):
    """The keys kernel in passes of ``depths`` layers, each above the last
    winner of the one before (what ``peel_keys`` runs for
    ``pass_depths``); returns (t1, sid) concatenated along K."""
    import torch

    from rtgs_tpu_torch.ops.peel import peel_keys_cuda

    t1s, sids, floor = [], [], None
    for k in depths:
        t1, sid = peel_keys_cuda(packed, cand, counts, lb, pix, k,
                                 floor=floor)
        t1s.append(t1)
        sids.append(sid)
        floor = (t1[:, -1].contiguous(), sid[:, -1].contiguous())
    return torch.cat(t1s, dim=1), torch.cat(sids, dim=1)


def phase19_keys(g1m, dev):
    """The keys kernel chained at CHAIN_DEPTHS against one twin call at
    1M@256x192, bitwise, one launch a pass, and in the other cuts of
    PASS_SPLITS."""
    import torch

    from rtgs_tpu_torch.ops.peel import (MAX_DEPTH, pass_depths, peel_keys,
                                         peel_keys_cuda, peel_keys_torch)

    _, packed, cand, counts, lb, pix = keys_inputs(g1m, CFG_1M_GATE, dev)
    t, c = cand.shape
    for depth in CHAIN_DEPTHS:
        t1_t, sid_t = peel_keys_torch(packed, cand, pix, depth)
        depths = tuple(pass_depths(depth))
        before = peel_keys_cuda.launches
        t1_k, sid_k = peel_keys(packed, cand, pix, depth, chunk_lb=lb,
                                counts=counts)
        torch.cuda.synchronize()
        launched = peel_keys_cuda.launches - before
        check(launched == len(depths), f"keys at depth {depth}: {launched} "
              f"launches for {len(depths)} passes")
        check(torch.equal(sid_k, sid_t) and torch.equal(t1_k, t1_t),
              f"keys chained at depth {depth}: ids or t1 differ from one "
              f"twin call at {int((sid_k != sid_t).sum())} entries")
        past = int((sid_t[:, MAX_DEPTH:] >= 0).sum())
        full = float((sid_t[:, -1] >= 0).float().mean())
        cuts = []
        for split in (depths,) + tuple(x for x in PASS_SPLITS.get(depth, ())
                                       if x != depths):
            t1_s, sid_s = keys_passes(packed, cand, counts, lb, pix, split)
            check(torch.equal(sid_s, sid_t) and torch.equal(t1_s, t1_t),
                  f"keys in passes {split}: differ from one twin call")
            cuts.append("+".join(map(str, split)))
        say(19, f"keys 1M@256x192 (T={t} C={c} P={pix.shape[1]}) at depth "
                f"{depth}: {len(depths)} passes, ids and t1 bitwise one "
                f"twin call, with the early exit; {past} winners past layer "
                f"{MAX_DEPTH}, {full:.1%} of pixels fill all {depth} layers; "
                f"passes cut as {', '.join(cuts)}, each bitwise the twin")
        del t1_t, sid_t, t1_k, sid_k


def phase19_peels(label, g, cfg, dev, need_deep=False):
    """The fused and top-K forward kernels chained at DEEP at one
    configuration: the passes' winners bitwise one twin call's (slots, and
    the top-K t1), radiance, transmittance, α and rgb to FWD_ATOL; the
    dispatchers' chains equal the passes chained by hand; their backward
    against one twin call (:func:`deep_backward`; ``need_deep``: some
    splat must win only past layer MAX_DEPTH)."""
    import torch

    from rtgs_tpu_torch.ops.peel import (MAX_DEPTH, pass_depths, peel_fused,
                                         peel_fused_cuda, peel_fused_torch,
                                         peel_topk, peel_topk_cuda,
                                         peel_topk_torch)

    _, packed, cand, counts, _, pix = keys_inputs(g, cfg, dev)
    t, p = cand.shape[0], pix.shape[1]
    depths = pass_depths(DEEP)
    slots, floor = [], None
    for k in depths:
        last = torch.empty((t, p), device=dev)
        _, _, sl = peel_fused_cuda(packed, cand, counts, pix, k, floor=floor,
                                   out_last_t1=last)
        slots.append(sl)
        floor = (last, sl[:, -1].contiguous())
    sl_k = torch.cat(slots, dim=1)
    with torch.no_grad():
        rad_k, tr_k = peel_fused(packed, cand, pix, DEEP)
    rad_p, tr_p, sl_p = plain_in_bands(
        lambda c, q: peel_fused_torch(packed, c, q, DEEP), t, cand, pix)
    torch.cuda.synchronize()
    check(torch.equal(sl_k, sl_p), f"fused chained at depth {DEEP}: slots "
          f"differ from one twin call at {int((sl_k != sl_p).sum())} entries")
    fwd_err = max(float((rad_k - rad_p).abs().max()),
                  float((tr_k - tr_p).abs().max()))
    check(fwd_err <= FWD_ATOL, f"fused chained at depth {DEEP}: max |kernel "
          f"− twin| {fwd_err} > {FWD_ATOL}")

    lays, slots, floor = [], [], None
    for k in depths:
        lay, sl = peel_topk_cuda(packed, cand, counts, pix, k, floor=floor)
        lays.append(lay)
        slots.append(sl)
        floor = (lay[:, 0, -1].contiguous(), sl[:, -1].contiguous())
    lay_k, slt_k = torch.cat(lays, dim=2), torch.cat(slots, dim=1)
    with torch.no_grad():
        via = torch.stack(peel_topk(packed, cand, pix, DEEP), dim=1)
    check(torch.equal(via.transpose(2, 3), lay_k), "peel_topk differs from "
          "its passes chained by hand")
    lay_p, slt_p = plain_in_bands(
        lambda c, q: peel_topk_torch(packed, c, q, DEEP), t, cand, pix)
    torch.cuda.synchronize()
    check(torch.equal(slt_k, slt_p) and torch.equal(lay_k[:, 0],
                                                    lay_p[:, 0]),
          f"top-K chained at depth {DEEP}: slots or t1 differ from one twin "
          f"call")
    topk_err = float((lay_k[:, 1:] - lay_p[:, 1:]).abs().max())
    check(topk_err <= FWD_ATOL, f"top-K chained at depth {DEEP}: α/rgb "
          f"max |kernel − twin| {topk_err} > {FWD_ATOL}")
    check(torch.equal(slt_k, sl_k), "the top-K and fused chains picked "
          "other winners")
    past = int((sl_p[:, MAX_DEPTH:] >= 0).sum())
    bwd = deep_backward(packed, cand, pix, sl_p, rad_k.shape, lay_k.shape,
                        need_deep, dev)
    say(19, f"fused and top-K at {label} (T={t} C={cand.shape[1]}) at "
            f"depth {DEEP} in {len(depths)} passes: slots bitwise one twin "
            f"call's (top-K t1 too), radiance/transmittance max |diff| "
            f"{fwd_err:.2e}, α/rgb {topk_err:.2e}; {past} winners past layer "
            f"{MAX_DEPTH}")
    say(19, f"backward of the chains at {label}, depth {DEEP}, under "
            f"autograd with seeded cotangents: " + "; ".join(
                f"{name}: {b['launches']} launches (one a pass), table "
                f"gradient against one twin call's at depth {DEEP}: max "
                f"|diff| {b['abs']:.3e}, per lane {b['lane']:.3e} of the "
                f"lane's largest, on the {b['deep_rows']} splats that win "
                f"only past layer {MAX_DEPTH} {b['deep_lane']:.3e} of their "
                f"lane's largest (limit {BWD_LANE_RTOL:g} both)"
                for name, b in bwd.items()))


def deep_backward(packed, cand, pix, slots, rad_shape, lay_shape,
                  need_deep, dev):
    """The fused and top-K chains' backward at DEEP under autograd, on
    seeded cotangents, against one twin backward at DEEP on the twin's
    winners ``slots``: the (N+1, 64) table gradient held by
    ``table_errors``, and again on the rows of the splats that win only
    past layer MAX_DEPTH (those reach the table through the later passes
    alone, so a fault there shows against their own scale). The backward
    kernels must run once a pass. Returns, by path, the launches and the
    errors."""
    import torch

    from rtgs_tpu_torch.ops.peel import (MAX_DEPTH, _safe_ids, pass_depths,
                                          peel_fused,
                                         peel_fused_bwd_cuda,
                                         peel_fused_bwd_torch, peel_topk,
                                         peel_topk_bwd_cuda,
                                         peel_topk_bwd_torch)

    t = cand.shape[0]
    # Bit 1: the splat wins a layer below MAX_DEPTH somewhere; bit 2: past.
    won_at = torch.zeros(packed.shape[0], dtype=torch.int32, device=dev)
    for s in range(0, t, PLAIN_BAND):
        band = slots[s:s + PLAIN_BAND]
        sid = _safe_ids(packed, cand[s:s + PLAIN_BAND].gather(
            1, band.clamp(min=0).flatten(1).long()).where(
                band.flatten(1) >= 0, -1)).reshape(band.shape)
        won_at[sid[:, :MAX_DEPTH].reshape(-1)] |= 1
        won_at[sid[:, MAX_DEPTH:].reshape(-1)] |= 2
    deep_rows = won_at == 2
    deep_rows[-1] = False
    n_deep = int(deep_rows.sum())
    check(n_deep > 0 or not need_deep, f"no splat wins only past layer "
          f"{MAX_DEPTH}: the later passes' backward goes unchecked")
    gen = torch.Generator(device=dev).manual_seed(1)
    g_rad = torch.randn(rad_shape, generator=gen, device=dev)
    g_tr = torch.randn(rad_shape[:1] + rad_shape[2:], generator=gen,
                       device=dev)
    g_lay = torch.randn(lay_shape, generator=gen, device=dev)
    g_lay[:, 0] = 0.0                       # t1's cotangent is dropped

    def through(run, counter):
        leaf = packed.detach().clone().requires_grad_()
        before = counter.launches
        outs, cots = run(leaf)
        torch.autograd.backward(outs, cots)
        torch.cuda.synchronize()
        return leaf.grad, counter.launches - before

    d_f, n_f = through(lambda x: (peel_fused(x, cand, pix, DEEP),
                                  (g_rad, g_tr)), peel_fused_bwd_cuda)
    ref_f = table_in_bands(
        packed, lambda c, q, sl, gr, gt: peel_fused_bwd_torch(
            packed, c, q, sl, gr, gt), t, cand, pix, slots, g_rad, g_tr)
    lay_cots = tuple(g_lay.transpose(2, 3).unbind(1))
    d_t, n_t = through(lambda x: (peel_topk(x, cand, pix, DEEP), lay_cots),
                       peel_topk_bwd_cuda)
    ref_t = table_in_bands(
        packed, lambda c, q, sl, gl: peel_topk_bwd_torch(packed, c, q, sl,
                                                         gl),
        t, cand, pix, slots, g_lay[:, 1:])
    out = {}
    n_pass = len(pass_depths(DEEP))
    for name, got, ref, n in (("peel_fused", d_f, ref_f, n_f),
                              ("peel_topk", d_t, ref_t, n_t)):
        check(n == n_pass, f"{name} at depth {DEEP}: the backward kernel "
              f"ran {n} times for {n_pass} passes")
        abs_err, lane = table_errors(f"{name} backward at depth {DEEP}", got,
                                     ref)
        deep_lane = 0.0
        if n_deep:
            got, ref = got[deep_rows], ref[deep_rows]
            deep_lane = float(((got - ref).abs().amax(dim=0)
                               / (ref.abs().amax(dim=0) + 1e-30)).max())
            check(deep_lane <= BWD_LANE_RTOL, f"{name} backward at depth "
                  f"{DEEP}: per-lane error {deep_lane} > {BWD_LANE_RTOL} on "
                  f"the splats that win only past layer {MAX_DEPTH}")
        out[name] = dict(launches=n, abs=abs_err, lane=lane,
                         deep_lane=deep_lane, deep_rows=n_deep)
    return out


def deep_frame(g, cam, depth, kw):
    """One banded keys frame at ``depth`` as ``render_tiled_keys`` runs it,
    its keys passes launched here: returns (the image, the residual
    transmittance (T, P) Π(1 − α), and which pixels have a hit (T, P))."""
    import torch

    from rtgs_tpu_torch.ops.peel import CHUNK, pass_depths
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             _tiles_to_image,
                                             composite_layers_kp,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features,
                                             shade_winners_kp)

    w, h = cam.buf_size
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, TILE)
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"],
                        narrow=kw["bin_narrow"], chunk=CHUNK,
                        entry_lb=entry_lower_bound(g, cam, packed))
    t = b.candidates.shape[0]
    nb = -(-t // kw["tile_bands"])
    depths = pass_depths(depth)
    rads, trans, hit = [], [], []
    for s in range(0, t, nb):
        _, sid = keys_passes(packed, b.candidates[s:s + nb],
                             b.counts[s:s + nb], b.chunk_lb[s:s + nb],
                             pix[s:s + nb], depths)
        layers = shade_winners_kp(packed, sid, pix[s:s + nb])
        rads.append(composite_layers_kp(*layers))
        trans.append(torch.prod(1.0 - layers[0], dim=1))
        hit.append(sid[:, 0] >= 0)
    img = _tiles_to_image(torch.cat(rads), b.n_tiles_x, b.n_tiles_y,
                          TILE)[:w, :h]
    return img, torch.cat(trans), torch.cat(hit)


def phase19_frames(g1m, dev, tmp):
    """``render -d DEEP`` and a 3-frame ``orbit`` through the CLI at
    1M@1920x1088 in 8 bands (the keys kernel once a pass a band), then in
    process at FRAME_DEPTHS: the frame with its passes launched here
    against ``render_tiled_keys``, peak memory and the residual
    transmittance. Returns the keys launches of the CLI run."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import pass_depths, peel_keys_cuda
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import save_scene

    ply = tmp / "scene_1m.ply"
    save_scene(ply, g1m)
    w, h = FULL_RES
    argv = ["-o", str(ply), "-r", f"{w},{h}", "-d", str(DEEP),
            "--fov", str(BENCH_POSE["fov"]), "--radius", str(BENCH_POSE["r"]),
            "--theta", str(BENCH_POSE["theta"]),
            "--phi", str(BENCH_POSE["phi"]),
            "--max-candidates", "3584", "--tile-bands", str(BANDS),
            "--bin-narrow", "4", "--renderer", "keys", "--device", "cuda"]
    peel_keys_cuda.launches = 0
    run_quiet(cli, ["render", *argv, "--output", str(tmp / "deep.npy")])
    run_quiet(cli, ["orbit", *argv, "--frames", str(ORBIT_FRAMES),
                    "--output", str(tmp / "deep_orbit")])
    torch.cuda.synchronize()
    launches = peel_keys_cuda.launches
    frames = 1 + ORBIT_FRAMES
    want = BANDS * len(pass_depths(DEEP)) * frames
    check(launches == want, f"deep CLI: keys kernel launched {launches} "
          f"times, expected {want}")
    saved = [tmp / "deep.npy"] + sorted((tmp / "deep_orbit").glob("frame_*"))
    check(len(saved) == frames and saved[0].is_file(),
          f"deep CLI: expected {frames} frames, found "
          f"{[p.name for p in saved]}")
    for p in saved:
        if p.suffix == ".npy":
            img8 = np.load(p)
            check(img8.shape == (h, w, 3) and img8.max() > 0,
                  f"deep CLI {p.name}: shape {img8.shape}, max {img8.max()}")
    say(19, f"CLI render + orbit --frames {ORBIT_FRAMES} at depth {DEEP}, "
            f"1M@{w}x{h}, {BANDS} bands: {frames} frames; keys launches "
            f"{launches} ({len(pass_depths(DEEP))} passes a band)")

    cam = bench_camera(FULL_RES, dev)
    kw = dict(max_candidates=3584, max_global=64, tile_bands=BANDS,
              bin_narrow=4)
    for depth in FRAME_DEPTHS:
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            ref = render_tiled_keys(g1m, cam, depth=depth, tile=TILE, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            img, trans, hit = deep_frame(g1m, cam, depth, kw)
        check(torch.equal(img, ref), f"depth {depth}: the frame with its "
              f"passes launched here differs from render_tiled_keys")
        check(bool(torch.isfinite(ref).all()) and float(ref.max()) > 0.05,
              f"depth {depth}: image not finite or black")
        tr, tr_hit = trans.reshape(-1), trans[hit]
        say(19, f"frame 1M@{w}x{h} at depth {depth} ({BANDS} bands): the "
                f"frame with its passes launched here bitwise "
                f"render_tiled_keys'; peak device memory {peak:.2f} GiB; "
                f"residual "
                f"transmittance mean {float(tr.mean()):.4f}, p99 "
                f"{float(torch.quantile(tr, 0.99)):.4f}, share of pixels "
                f"above 0.01 {float((tr > 0.01).float().mean()):.2%}; over "
                f"the {tr_hit.numel()} pixels with a hit mean "
                f"{float(tr_hit.mean()):.4f}, p99 "
                f"{float(torch.quantile(tr_hit, 0.99)):.4f}, above 0.01 "
                f"{float((tr_hit > 0.01).float().mean()):.2%}")
        del img, ref, trans, hit
    return launches


def winners_past(g, cams, cfg, dev):
    """Per view, the keys path's winners at DEEP past layer MAX_DEPTH."""
    import torch

    from rtgs_tpu_torch.ops.peel import MAX_DEPTH, peel_keys

    out = []
    for cam in cams:
        _, packed, cand, counts, lb, pix = keys_inputs(g, cfg, dev, cam=cam)
        with torch.no_grad():
            sid = peel_keys(packed, cand, pix, DEEP, chunk_lb=lb,
                            counts=counts)[1]
        out.append(int((sid[:, MAX_DEPTH:] >= 0).sum()))
    return out


def density_cost(g1m, deep_views):
    """What the density pass does to the 1M@256x192 fit: the last step's
    PSNR of FIT_CLI_STEPS `pallas` steps with the pass at step 10 and
    without, at DEPTH and at DEEP (``deep_views``: the views at DEEP).
    Printed, not checked: it says why phase 19's 1M fit runs without."""
    out = []
    for depth in (DEPTH, DEEP):
        ds = (deep_views if depth == DEEP
              else fit_views(g1m, "pallas", depth, CFG_1M_GATE))
        mid, psnr = FIT_CLI_STEPS // 2, {}
        for densify in (True, False):
            solver = refit_solver(g1m, ds, "pallas", FIT_CLI_STEPS,
                                  depth=depth, budgets=CFG_1M_GATE,
                                  densify=densify)
            log = [solver.train_step()["psnr"] for _ in range(FIT_CLI_STEPS)]
            psnr[densify] = " / ".join(f"{log[i]:.4f}"
                                       for i in (0, mid - 1, mid, -1))
        out.append(f"depth {depth}: PSNR at steps 1, {mid}, {mid + 1}, "
                   f"{FIT_CLI_STEPS} with the pass {psnr[True]}, without "
                   f"{psnr[False]}")
    say(19, f"the density pass at step {FIT_CLI_STEPS // 2} on the "
            f"1M@256x192 fit through pallas: " + "; ".join(out))


def phase19_fits_serve(g100k, g1m, dev):
    """20 fit steps at DEEP through ``pallas`` and ``keys``, twice each,
    at the fit cell (100k@512x384, where no pixel has more than MAX_DEPTH
    hits) and at 1M@256x192 (where some do, so the later passes carry
    winners forward and gradients back): PSNR must rise and every
    parameter repeat bitwise; then one ``serve`` frame at DEEP, bitwise the
    in-process render. The 1M fit runs without the density pass, which
    lowers that fit's PSNR at depth 16 as at DEEP (:func:`density_cost`
    prints by how much). Returns the launches of the kernels on these
    paths."""
    import argparse
    import threading

    import torch

    from rtgs_tpu_torch.camera import image_to_display
    from rtgs_tpu_torch.ops.peel import (MAX_DEPTH, pass_depths,
                                         peel_fused_bwd_cuda,
                                         peel_fused_cuda, peel_keys_cuda,
                                         segment_rows_cuda)
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.utils.image import decode_png, to_uint8
    from rtgs_tpu_torch.viewer.server import make_server

    deep_ds = {r: fit_views(g1m, r, DEEP, CFG_1M_GATE)
               for r in ("pallas", "keys")}
    past = winners_past(g1m, deep_ds["keys"].cameras, CFG_1M_GATE, dev)
    check(sum(past) > 0, f"the 1M fit's views have no winner past layer "
          f"{MAX_DEPTH} at depth {DEEP}")
    density_cost(g1m, deep_ds["pallas"])
    counters = (peel_keys_cuda, peel_fused_cuda, peel_fused_bwd_cuda,
                segment_rows_cuda)
    for f in counters:
        f.launches = 0
    n_pass = len(pass_depths(DEEP))
    fits = {}
    w, h = CFG_FIT["res"]
    for cell, g, cfg, views in ((f"100k@{w}x{h}", g100k, CFG_FIT, {}),
                                ("1M@256x192", g1m, CFG_1M_GATE, deep_ds)):
        for r in ("pallas", "keys"):
            torch.cuda.reset_peak_memory_stats()
            fits[cell, r] = train_twice(g, r, depth=DEEP, cfg=cfg,
                                        ds=views.get(r),
                                        densify=g is g100k) + (
                torch.cuda.max_memory_allocated() / 2**30,)
            first, last = fits[cell, r][:2]
            check(last > first, f"fit at {cell}, depth {DEEP} through {r}: "
                  f"PSNR {first:.4f} -> {last:.4f} dB did not rise")
    want = 2 * sum(r == "pallas" for _, r in fits) * FIT_CLI_STEPS * n_pass
    check(peel_fused_bwd_cuda.launches == want,
          f"pallas fits at depth {DEEP}: {peel_fused_bwd_cuda.launches} "
          f"backward launches, expected {want}")
    launches = {f.__name__: f.launches for f in counters}
    say(19, f"{FIT_CLI_STEPS} fit steps at depth {DEEP} ({n_pass} passes), "
            f"twice from the same state (the 1M@256x192 views have "
            f"{sum(past)} winners past layer {MAX_DEPTH}, "
            f"{min(past)}-{max(past)} a view; no density pass there): "
            + "; ".join(f"{cell} {r}: every parameter, the mask and every "
                        f"step's loss and PSNR bitwise equal, PSNR {a:.4f} "
                        f"-> {b:.4f} dB, {live} live, peak {peak:.2f} GiB"
                        for (cell, r), (a, b, live, peak) in fits.items())
            + f"; launches {launches}")
    del deep_ds

    args = argparse.Namespace(res=FULL_RES, fov=BENCH_POSE["fov"], depth=DEEP,
                              renderer="keys", radius=BENCH_POSE["r"], port=0)
    server, session = make_server(g1m, args, render_kwargs=SERVE_KW)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        peel_keys_cuda.launches = 0
        png = http_get(port, "/frame")
        n = peel_keys_cuda.launches
        launches["peel_keys_cuda"] += n
        check(n == BANDS * n_pass, f"serve at depth {DEEP}: a frame launched "
              f"the keys kernel {n} times, expected {BANDS * n_pass}")
        with torch.inference_mode():
            ref = render(g1m, session.camera(), depth=DEEP, renderer="keys",
                         **SERVE_KW)
            ref8 = to_uint8(image_to_display(ref).cpu().numpy())
        got = decode_png(png)
        check(got.shape == (FULL_RES[1], FULL_RES[0], 3)
              and bool((got == ref8).all()), f"serve at depth {DEEP}: the "
              f"PNG frame is not bitwise the in-process render")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "serve: the server thread did not stop")
    say(19, f"serve at depth {DEEP}, 1M@{FULL_RES[0]}x{FULL_RES[1]}: GET "
            f"/frame bitwise the in-process render; keys launches {n}")
    return launches


def phase19_deep(g100k, g1m, dev):
    """Phase 19: peels deeper than one kernel's list. Returns the launches
    of the deep main path (CLI, fits, viewer) by kernel."""
    phase19_keys(g1m, dev)
    w, h = CFG_FIT["res"]
    phase19_peels(f"100k@{w}x{h}", g100k, CFG_FIT, dev)
    phase19_peels("1M@256x192", g1m, CFG_1M_GATE, dev, need_deep=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli_keys = phase19_frames(g1m, dev, pathlib.Path(tmp))
    launches = phase19_fits_serve(g100k, g1m, dev)
    launches["peel_keys_cuda"] += cli_keys
    for name, n in launches.items():
        check(n > 0, f"{name} was launched no time on the deep main path")
    return launches


def fused_frame(g, cam, depth, kw):
    """One banded frame of the default path as ``render_tiled_pallas`` runs
    it, its stages launched here: features (the packed table and the pixel
    table), binning (candidates padded to a multiple of CHUNK), then each
    band's ``peel_fwd`` passes, each above the last winner of the pass
    before, chained as ``peel_fused`` chains them. Returns the image and
    the inputs of the band with the most live pairs."""
    import torch
    import torch.nn.functional as F

    from rtgs_tpu_torch.ops.peel import (CHUNK, _counts, pass_depths,
                                         peel_fused_cuda)
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             _tiles_to_image, pack_features,
                                             precompute_features)

    w, h = cam.buf_size
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, TILE)
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"],
                        narrow=kw["bin_narrow"])
    cand = F.pad(b.candidates, (0, (-b.candidates.shape[1]) % CHUNK),
                 value=-1)
    t, p = cand.shape[0], pix.shape[1]
    nb = -(-t // kw["tile_bands"])
    depths = pass_depths(depth)
    rads = []
    for s in range(0, t, nb):
        cb, qb = cand[s:s + nb], pix[s:s + nb]
        rad = trans = floor = None
        for j, k in enumerate(depths):
            last = (torch.empty((cb.shape[0], p), dtype=torch.float32,
                                device=cand.device)
                    if j + 1 < len(depths) else None)
            r, tr, sl = peel_fused_cuda(packed, cb, _counts(cb), qb, k,
                                        floor=floor, out_last_t1=last)
            if rad is None:
                rad, trans = r, tr
            else:
                rad = rad + trans[:, None] * r
                trans = trans * tr
            floor = None if last is None else (last, sl[:, -1].contiguous())
        rads.append(rad)
    img = _tiles_to_image(torch.cat(rads).transpose(1, 2), b.n_tiles_x,
                          b.n_tiles_y, TILE)[:w, :h]
    live = [int((cand[s:s + nb] >= 0).sum()) for s in range(0, t, nb)]
    s = nb * live.index(max(live))
    return img, dict(
        packed=packed, cand=cand[s:s + nb], pix=pix[s:s + nb],
        dropped=int(b.local_overflow) + int(b.global_overflow))


def dropped_pairs(g, cam, depth, kw, pixel_offset=None):
    """The binning counters of a default-path frame (``render(...,
    with_stats=True)``): (pairs dropped from full tiles, splats dropped
    from the full global list)."""
    import torch

    from rtgs_tpu_torch.render.api import render

    with torch.inference_mode():
        _, stats = render(g, cam, depth=depth, with_stats=True,
                          pixel_offset=pixel_offset, **kw)
    return int(stats["local_overflow"]), int(stats["global_overflow"])


def jitter_budgets(g, cam):
    """The smallest budgets, from SERVE_KW's up (the candidate budget in
    steps of CHUNK, the global list's in steps of 64), at which the
    jittered binning (boxes padded by 0.5 px) drops nothing; returns them
    and the counters of each budget tried."""
    from rtgs_tpu_torch.ops.peel import CHUNK

    kw, tried = dict(SERVE_KW), []
    for _ in range(8):
        local, glob = dropped_pairs(g, cam, DEPTH, kw, pixel_offset=(0, 0))
        tried.append(f"{kw['max_candidates']} / {kw['max_global']}: "
                     f"{local} local, {glob} global")
        if local + glob == 0:
            return kw, tried
        kw = dict(kw, max_candidates=kw["max_candidates"] + CHUNK * (local > 0),
                  max_global=kw["max_global"] + 64 * (glob > 0))
    raise SmokeFailure(f"the jittered binning drops pairs at every budget "
                       f"tried: {tried}")


def phase20_cli(g1m, tmp):
    """``render`` and a 3-frame ``orbit`` at depth 16, ``render`` at 64 and
    128, and ``bench`` at 16, through the CLI with no ``--renderer``:
    ``peel_fwd`` once a band and pass, the keys kernel never. Returns
    ``peel_fwd``'s launches."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.__main__ import main as cli
    from rtgs_tpu_torch.ops.peel import (pass_depths, peel_fused_cuda,
                                         peel_keys_cuda)
    from rtgs_tpu_torch.scene import save_scene

    ply = tmp / "scene_1m.ply"
    save_scene(ply, g1m)
    w, h = FULL_RES

    def argv(depth):
        return ["-o", str(ply), "-r", f"{w},{h}", "-d", str(depth),
                "--fov", str(BENCH_POSE["fov"]),
                "--radius", str(BENCH_POSE["r"]),
                "--theta", str(BENCH_POSE["theta"]),
                "--phi", str(BENCH_POSE["phi"]),
                "--max-candidates", "3584", "--tile-bands", str(BANDS),
                "--bin-narrow", "4", "--device", "cuda"]

    bench_iters = 5
    runs = [("render", DEPTH, 1, ["--output", str(tmp / "f16.npy")]),
            ("orbit", DEPTH, ORBIT_FRAMES,
             ["--frames", str(ORBIT_FRAMES), "--output", str(tmp / "orb")])]
    runs += [("render", d, 1, ["--output", str(tmp / f"f{d}.npy")])
             for d in FRAME_DEPTHS if d != DEPTH]
    runs.append(("bench", DEPTH, 1 + bench_iters + max(bench_iters // 2, 3),
                 ["--iters", str(bench_iters)]))
    launches = 0
    for cmd, depth, frames, extra in runs:
        peel_fused_cuda.launches = peel_keys_cuda.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli([cmd, *argv(depth), *extra])
        torch.cuda.synchronize()
        n, keys = peel_fused_cuda.launches, peel_keys_cuda.launches
        launches += n
        want = BANDS * len(pass_depths(depth)) * frames
        line = printed.getvalue().strip().splitlines()[-1]
        say(20, f"CLI {cmd} -d {depth} (no --renderer), 1M@{w}x{h}, {BANDS} "
                f"bands: peel_fwd launches {n} (expected {want}: {frames} "
                f"frames x {BANDS} bands x {len(pass_depths(depth))} "
                f"passes), keys launches {keys}")
        check(n == want and keys == 0, f"CLI {cmd} -d {depth}: peel_fwd "
              f"launched {n} times (expected {want}), keys {keys} (expected "
              f"0)")
        if cmd == "bench":
            m = BENCH_LINE.search(line)
            check(m is not None and float(m.group(1)) > 0,
                  f"bench printed {line!r}")
    saved = [tmp / f"f{d}.npy" for d in FRAME_DEPTHS]
    saved += sorted((tmp / "orb").glob("frame_*"))
    check(len(saved) == len(FRAME_DEPTHS) + ORBIT_FRAMES,
          f"phase 20 CLI: saved {[p.name for p in saved]}")
    for p in saved:
        if p.suffix == ".npy":
            img8 = np.load(p)
            check(img8.shape == (h, w, 3) and img8.max() > 0,
                  f"phase 20 CLI {p.name}: shape {img8.shape}, max "
                  f"{img8.max()}")
    return launches


def phase20_frames(g1m, dev):
    """The default frame in process at FRAME_DEPTHS against the keys path's
    in the same call: the frame with its passes launched here, peak
    memory, dropped pairs; at 16 the frame against the keys frame and the
    fused twin's banded frame; and one band's peel_fwd kernel against its
    twin (winners, radiance and transmittance bitwise)."""
    import torch

    from rtgs_tpu_torch.render.api import render, resolve_renderer
    from rtgs_tpu_torch.render.tiled import render_tiled_pallas

    w, h = FULL_RES
    cam = bench_camera(FULL_RES, dev)
    kw = SERVE_KW
    check(resolve_renderer("auto", g1m.num, g1m.device) == "pallas",
          "auto does not resolve to pallas for the 1M scene on the card")
    band = None
    for depth in FRAME_DEPTHS:
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            img = render(g1m, cam, depth=depth, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            ref = render(g1m, cam, depth=depth, renderer="keys", **kw)
            torch.cuda.synchronize()
            peak_k = torch.cuda.max_memory_allocated() / 2**30
            here, busiest = fused_frame(g1m, cam, depth, kw)
            check(torch.equal(here, img),
                  f"depth {depth}: the frame with its passes launched here "
                  f"differs from render(auto)")
            dropped = busiest["dropped"]
            check(dropped == 0 and sum(dropped_pairs(g1m, cam, depth,
                                                     kw)) == 0,
                  f"depth {depth}: the default frame dropped {dropped} pairs")
            check(bool(torch.isfinite(img).all()) and float(img.max()) > 0.05,
                  f"depth {depth}: the default frame is not finite or black")
            q, worst = compare_images(f"depth {depth}: default vs keys", img,
                                      ref)
            if depth == DEPTH:
                band = busiest
        say(20, f"default frame 1M@{w}x{h} at depth {depth} (pallas, "
                f"{BANDS} bands): bitwise the frame with its passes launched "
                f"here, peak {peak:.2f} GiB, dropped pairs {dropped}. Keys "
                f"path, same frame: peak {peak_k:.2f} GiB; images "
                f"{IMG_Q}-quantile |diff| {q:.2e}, max {worst:.2e} (limits "
                f"{IMG_QTOL:g}, {IMG_MAXTOL:g})")
        del img, ref, here, busiest

    # The whole frame at depth 16 through the fused twin, in bands of
    # PLAIN_BAND tiles (its float64 fields would not fit at once).
    with torch.inference_mode():
        img = render(g1m, cam, depth=DEPTH, **kw)
        ntiles = -(-w // TILE[0]) * -(-h // TILE[1])
        twin = render_tiled_pallas(
            g1m, cam, depth=DEPTH, tile=TILE, peel_impl="torch",
            **dict(kw, tile_bands=-(-ntiles // PLAIN_BAND)))
    q, worst = compare_images("depth 16: default vs the fused twin", img,
                              twin)
    same = torch.equal(img, twin)
    del img, twin

    say(20, f"depth 16 frame against the fused twin's (in "
            f"{-(-ntiles // PLAIN_BAND)} bands of {PLAIN_BAND} tiles): "
            f"{'bitwise equal' if same else 'not bitwise'}, {IMG_Q}-quantile "
            f"|diff| {q:.2e}, max {worst:.2e}")
    band_against_twin(band, 20, "the busiest full-width band")


def band_against_twin(band, phase, label):
    """One band (``fused_frame``'s busiest) through ``peel_fwd`` and its
    twin (in bands of PLAIN_BAND tiles) at depth 16 and at 64 (the deep
    pass, a lane pair a pixel): winners, radiance and transmittance
    bitwise."""
    import torch

    from rtgs_tpu_torch.ops.peel import (MAX_DEPTH, _counts, peel_fused_cuda,
                                         peel_fused_torch)

    packed, cand, pix = band["packed"], band["cand"], band["pix"]
    counts = _counts(cand)
    with torch.inference_mode():
        rad_k, tr_k, sl_k = peel_fused_cuda(packed, cand, counts, pix, DEPTH)
        rad_p, tr_p, sl_p = plain_in_bands(
            lambda c, x: peel_fused_torch(packed, c, x, DEPTH),
            cand.shape[0], cand, pix)
        torch.cuda.synchronize()
        check(torch.equal(sl_k, sl_p), f"peel_fwd at {label}: winners "
              f"differ from the twin's at {int((sl_k != sl_p).sum())} "
              f"entries")
        err = max(float((rad_k - rad_p).abs().max()),
                  float((tr_k - tr_p).abs().max()))
        check(err == 0.0, f"peel_fwd at {label}: radiance or "
              f"transmittance differs from the twin's by {err}")
        deep_k = peel_fused_cuda(packed, cand, counts, pix, MAX_DEPTH)
        deep_p = plain_in_bands(
            lambda c, x: peel_fused_torch(packed, c, x, MAX_DEPTH),
            cand.shape[0], cand, pix)
        torch.cuda.synchronize()
        for got, ref, what in zip(deep_k, deep_p, ("radiance",
                                                   "transmittance",
                                                   "winners")):
            check(torch.equal(got, ref), f"peel_fwd at {label}, K=64: "
                  f"{what} differs from the twin's")
    t, c = cand.shape
    say(phase, f"peel_fwd at {label} (T={t} C={c} P={pix.shape[1]} "
               f"K={DEPTH}, {int((cand >= 0).sum())} live pairs, "
               f"{int((sl_k >= 0).sum())} winners, of {packed.shape[0]} "
               f"table rows): winners, radiance and transmittance bitwise "
               f"the twin's, and at K=64 (lane pairs) too")


def phase20_serve(g1m, dev):
    """``serve`` over HTTP with its default renderer: a first frame (one
    peel_fwd launch a band, none of the keys kernel, bitwise the in-process
    ``render``), a cached one (no launch at all), pan, zoom and rotation,
    each pose's binning dropping nothing; then ``ProgressiveSampler`` x4
    with jitter at the smallest budgets whose padded binning drops nothing
    (:func:`jitter_budgets`). Returns peel_fwd's launches."""
    import argparse
    import threading

    import torch

    from rtgs_tpu_torch.camera import image_to_display
    from rtgs_tpu_torch.ops.peel import peel_fused_cuda, peel_keys_cuda
    from rtgs_tpu_torch.render.api import (ProgressiveSampler, render,
                                           render_progressive)
    from rtgs_tpu_torch.utils.image import decode_png, to_uint8
    from rtgs_tpu_torch.viewer.server import make_server

    w, h = FULL_RES
    args = argparse.Namespace(res=FULL_RES, fov=BENCH_POSE["fov"], depth=DEPTH,
                              renderer="auto", radius=BENCH_POSE["r"], port=0)
    server, session = make_server(g1m, args, render_kwargs=SERVE_KW)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    launches = 0
    try:
        def frame(label):
            nonlocal launches
            peel_fused_cuda.launches = peel_keys_cuda.launches = 0
            png = http_get(port, "/frame")
            n, keys = peel_fused_cuda.launches, peel_keys_cuda.launches
            launches += n
            dropped = sum(dropped_pairs(g1m, session.camera(), DEPTH,
                                        SERVE_KW))
            say(20, f"serve GET /frame ({label}): peel_fwd launches {n}, "
                    f"keys {keys}; the pose's binning drops {dropped} pairs")
            check(keys == 0 and dropped == 0, f"serve ({label}): {keys} keys "
                  f"launches, {dropped} dropped pairs")
            return png, n

        png, n = frame("first pose")
        check(n == BANDS, f"serve: a fresh frame launched peel_fwd {n} "
              f"times, expected {BANDS}")
        with torch.inference_mode():
            ref = render(g1m, session.camera(), depth=DEPTH, **SERVE_KW)
            ref8 = to_uint8(image_to_display(ref).cpu().numpy())
        got = decode_png(png)
        check(got.shape == (h, w, 3) and bool((got == ref8).all()),
              "serve: the PNG frame is not bitwise the in-process render")
        again, n = frame("same pose, cached")
        check(n == 0 and again == png, f"serve: a cached frame launched "
              f"peel_fwd {n} times or changed")
        seen = png
        for ev in SERVE_EVENTS:
            check(http_post(port, ev) == 204, f"serve: /event {ev} refused")
            nxt, n = frame(f"after {ev['type']}")
            check(n == BANDS and nxt != seen, f"serve: {ev['type']} gave an "
                  f"unchanged frame or {n} peel_fwd launches")
            seen = nxt
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "serve: the server thread did not stop")

    # Jitter pads every box by 0.5 px, so its tiles hold more pairs than
    # the centred frame's: the sampler runs at the smallest budgets that
    # drop nothing (a sample that drops pairs is another image).
    cam = bench_camera(FULL_RES, dev)
    kw, tried = jitter_budgets(g1m, cam)
    peel_fused_cuda.launches = peel_keys_cuda.launches = 0
    with torch.inference_mode():
        s = ProgressiveSampler(g1m, cam, depth=DEPTH, jitter=True,
                               generator=torch.Generator().manual_seed(3),
                               **kw)
        for _ in range(PROGRESSIVE_SAMPLES):
            s.sample()
        shown = s.display()
        n, keys = peel_fused_cuda.launches, peel_keys_cuda.launches
        launches += n
        ref = render_progressive(g1m, cam, depth=DEPTH,
                                 samples=PROGRESSIVE_SAMPLES, jitter=True,
                                 generator=torch.Generator().manual_seed(3),
                                 **kw)
        same = torch.equal(shown, ref)
    check(n == BANDS * PROGRESSIVE_SAMPLES and keys == 0,
          f"ProgressiveSampler: peel_fwd launched {n} times (expected "
          f"{BANDS * PROGRESSIVE_SAMPLES}), keys {keys}")
    check(same, "ProgressiveSampler with jitter differs from "
          "render_progressive with a generator of the same seed")
    say(20, f"ProgressiveSampler x{PROGRESSIVE_SAMPLES} jittered at 1M@"
            f"{w}x{h}: the padded binning's drops by budget (candidates / "
            f"global list) {'; '.join(tried)}, so it runs at "
            f"{kw['max_candidates']} / {kw['max_global']}: peel_fwd launches "
            f"{n}, keys {keys}; bitwise render_progressive of the same seed")
    return launches


def oracle_pixel_lists(g, cam, kw, img_o, img_f):
    """The pixel where the oracle's and the fused path's images differ
    most, and the first DEPTH + 1 hits of its ray as each lists them: the
    oracle's (id, f32 t1, α) from ``topk_hits``, the tile path's (id, slot,
    t1 rounded once from float64, α) from ``intersect_candidates``.
    Returns that text and whether both composite the same DEPTH splats."""
    import torch

    from rtgs_tpu_torch.camera import generate_ray_grid
    from rtgs_tpu_torch.rays import Rays
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.oracle import topk_hits
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             intersect_candidates,
                                             precompute_features)

    diff = (img_o - img_f).abs().amax(-1)                  # (W, H)
    x, y = divmod(int(diff.argmax()), diff.shape[1])
    rays = generate_ray_grid(cam)
    ray = Rays(*(f[x, y][None] for f in rays))
    t1_o, id_o, a_o, _ = topk_hits(g, ray, DEPTH + 1, with_index=True)
    tw, th = TILE
    nty = -(-cam.buf_size[1] // th)
    t, p = (x // tw) * nty + y // th, (x % tw) * th + y % th
    b = tile_candidates(g, cam, tile=TILE,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"])
    cand = b.candidates[t:t + 1]
    pix = _tile_pixel_features(cam, TILE)[t:t + 1]
    t1, alpha, _ = intersect_candidates(precompute_features(g, cam), cand,
                                        pix[..., :3])
    t1_s, order = torch.sort(t1[0, p], stable=True)
    rows = []
    for k in range(DEPTH + 1):
        rows.append(
            f"{k}: oracle ({int(id_o[0, k])}, {float(t1_o[0, k]):.9g}, "
            f"{float(a_o[0, k]):.6g}) fused ({int(cand[0, order[k]])} in "
            f"slot {int(order[k])}, {float(t1_s[k]):.9g}, "
            f"{float(alpha[0, p, order[k]]):.6g})")
    hit_o = torch.isfinite(t1_o[0, :DEPTH])
    hit_f = torch.isfinite(t1_s[:DEPTH])
    same = (set(id_o[0, :DEPTH][hit_o].tolist())
            == set(cand[0, order[:DEPTH]][hit_f].tolist()))
    return (f"pixel ({x}, {y}), |diff| {float(diff[x, y]):.3e}: "
            + "; ".join(rows)), same


def phase20_threshold(dev):
    """The oracle against the fused path at the JAX threshold
    (_ORACLE_MAX_N): the 4096-splat scene of phase 10 and the same scene
    with a 4097th splat far outside the view, at 1920x1088 and 640x384.
    ``auto`` must take the oracle at 4096 and ``peel_fwd`` at 4097, and
    the images are held to each other by the image statistic (the worst
    pixel may exceed its max only where both composite the same splats in
    another order)."""
    import torch

    from rtgs_tpu_torch import gaussians as G
    from rtgs_tpu_torch.ops.peel import peel_fused_cuda
    from rtgs_tpu_torch.render.api import _ORACLE_MAX_N, render
    from rtgs_tpu_torch.scene import random_scene

    g4k = random_scene(ORACLE_N, device=dev, **SCENE_4K)
    check(g4k.num == _ORACLE_MAX_N, "the oracle scene is not at the "
          "threshold")
    far = {f: getattr(g4k, f) for f in G.FIELDS}
    far = G.Gaussians(**{f: torch.cat([v, v[:1]]) for f, v in far.items()})
    far.means[-1] += 100.0
    # Budgets of the whole scene, as phase 10's: its wide splats overflow
    # the default global list, and the comparison needs nothing dropped.
    kw = dict(max_candidates=ORACLE_N + 1, max_global=ORACLE_N + 1)
    for res in (FULL_RES, ORACLE_RES):
        cam = bench_camera(res, dev)
        out = {}
        with torch.inference_mode():
            for label, g in (("4096", g4k), ("4097", far)):
                peel_fused_cuda.launches = 0
                img = render(g, cam, depth=DEPTH, **kw)
                out[label] = (img, peel_fused_cuda.launches)
            check(out["4096"][1] == 0 and out["4097"][1] == 1,
                  f"auto at {res}: peel_fwd launched {out['4096'][1]} / "
                  f"{out['4097'][1]} times at 4096 / 4097 splats (expected "
                  f"0 / 1)")
            dropped = sum(dropped_pairs(far, cam, DEPTH, kw))
            check(dropped == 0, f"threshold {res}: {dropped} dropped")
            img_o, img_f = out["4096"][0], out["4097"][0]
            diff = (img_o - img_f).abs()
            q, worst = quantile(diff, IMG_Q), float(diff.max())
            lists, same = oracle_pixel_lists(g4k, cam, kw, img_o, img_f)
            # The oracle's t1 is the reference's f32 chain, the fused
            # path's float64 rounded once: two hits within the f32 chain's
            # error may composite in either order (ROADMAP.md §3). So the
            # worst pixel must hold the same splats when it exceeds the
            # image statistic's max.
            check(q < IMG_QTOL and (worst < IMG_MAXTOL or same),
                  f"oracle at 4096 vs peel_fwd at 4097, {res}: {IMG_Q}-"
                  f"quantile |diff| {q:.2e} (limit {IMG_QTOL:g}), max "
                  f"{worst:.2e} (limit {IMG_MAXTOL:g} unless the worst "
                  f"pixel composites the same splats: {same}); {lists}")
        say(20, f"threshold at {res[0]}x{res[1]}: auto took the oracle "
                f"at 4096 and peel_fwd at 4097; their images {IMG_Q}-"
                f"quantile |diff| {q:.2e}, max {worst:.2e}; the worst "
                f"pixel's hits (id, t1, alpha) a layer, the same splats on "
                f"both sides: {same}: {lists}")
        del out


def phase20_default(g1m, dev):
    """Phase 20: the default path, with no renderer named. Returns
    peel_fwd's launches on it."""
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase20_cli(g1m, pathlib.Path(tmp))
    phase20_frames(g1m, dev)
    launches += phase20_serve(g1m, dev)
    phase20_threshold(dev)
    from rtgs_tpu_torch.ops import _build

    log = _build.library_path().with_suffix(".log")
    regs = [e for e in ptxas_summary(log.read_text()).split(" | ")
            if e.startswith(("peel_fwd_kernel K=16:", "peel_fwd_kernel K=64:"))]
    say(20, f"peel_fwd.cu registers from the build: {' | '.join(regs)}")
    # The deep pass's layout exists for its residency: 16 warps an SM or
    # more, and no local memory.
    for e in regs:
        if e.startswith("peel_fwd_kernel K=64:"):
            warps = int(re.search(r"\((\d+) warps\)", e).group(1))
            check(warps >= 16 and "0 bytes spill stores" in e,
                  f"peel_fwd's deep pass: {e}")
    say(20, f"the default path launched peel_fwd {launches} times and the "
            f"keys kernel never")
    return launches


# Phase 21: the JAX package's production-scale tools through the port's
# probes (scripts/make_scene.py, fitbench.py, fitscratch.py, imquality.py,
# trace_step.py; kbench.py, keystage.py and stageprobe.py as probes.stages).
STRUCT_N, STRUCT_SMALL, STRUCT_SMALL_RES = 1_000_000, 250_000, (1280, 720)
# The structured scene seen whole: the bench pose's angles at radius 10.
# From the bench's radius 5 the camera stands inside the ground plane's
# extent (its corners lie 6.4 from the center), and the binning's global
# list outgrows any budget the CLI can pass (phase 21 prints it).
STRUCT_POSE = dict(BENCH_POSE, r=10.0)
# The JAX package's own command for its 250k structured scene
# (BASELINE.md:223-226): render --renderer pallas --max-candidates 2048
# --tile-bands 4.
JAX_STRUCT_CMD = ("pallas", 2048, 4)
FITBENCH_STEPS = 300          # scripts/fitbench.py's defaults: 300 steps,
FITBENCH_VIEWS = 12           # 12 views at 512x384, 1536 candidates
FITSCRATCH_STEPS = 1200       # BASELINE.md:136-150's standard run
FITSCRATCH_CUT = 300          # the keys run and the bitwise repeat
# The growth, live count and PSNR rise are asserted at this step of the
# standard run: from step ~815 the f32 exponent (F2) renders some steps'
# images at up to 4e18, so the last steps' PSNR says nothing of the fit.
FITSCRATCH_GATE = 800
# The script's code fits a uniform box (random_scene): there its seeds'
# isotropic scale (the median nearest-neighbour distance of 512 seeds,
# ~0.30) exceeds the world-size prune (0.1 x the 90th percentile of |mean|,
# ~0.26), and the first density pass prunes 99% of them in both packages
# (fault F11): FITSCRATCH_COLLAPSE steps of it are reported. The asserted
# runs fit the structured scene its docstring names. Its large seeds fan
# out wide, and the wide class's budget (N/16) spills to the global list:
# over the 1,200 steps each frame's least clean budgets reach 4,288
# candidates and a global list of 12,648 (the script's 1536 / 128 drop
# ~11k pairs a step), so the fits bin at FITSCRATCH_BUDGETS.
FITSCRATCH_COLLAPSE = 150
FITSCRATCH_BUDGETS = dict(cand=4352, glob=12800)
TRACE_STEPS = 3
IMQ_MIN_PSNR, IMQ_MIN_SSIM = 40.0, 0.999


def counted(fn):
    """``fn()`` with the launch counts of the four kernels a fit or a
    render runs set to 0 before and read after; returns (result, counts)."""
    from rtgs_tpu_torch.ops.peel import (peel_fused_bwd_cuda,
                                         peel_fused_cuda, peel_keys_cuda,
                                         segment_rows_cuda)

    wrappers = {"keys_sid": peel_keys_cuda, "peel_fwd": peel_fused_cuda,
                "peel_bwd": peel_fused_bwd_cuda,
                "segment_rows": segment_rows_cuda}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def struct_cli(ply, res, renderer, budget, bands, out):
    """``render`` of a structured scene through the CLI at STRUCT_POSE,
    depth 16, its printed line dropped; returns the launches."""
    from rtgs_tpu_torch.__main__ import main as cli

    argv = ["render", "-o", str(ply), "-r", f"{res[0]},{res[1]}", "-d",
            str(DEPTH), "--fov", str(STRUCT_POSE["fov"]), "--radius",
            str(STRUCT_POSE["r"]), "--theta", str(STRUCT_POSE["theta"]),
            "--phi", str(STRUCT_POSE["phi"]), "--max-candidates",
            str(budget), "--tile-bands", str(bands), "--device", "cuda",
            "--output", str(out)]
    if renderer:
        argv += ["--renderer", renderer]
    return counted(lambda: run_quiet(cli, argv))[1]


def phase21_make_scene(g1m, dev, tmp):
    """The structured scene: written by the probe's CLI at 1M and 250k and
    reloaded; its candidate counts beside the uniform scene's; the least
    clean budgets; ``render`` through the CLI (default and keys, 8 bands;
    the JAX package's 250k command and the same at the least clean
    budget), 0 dropped pairs wherever asserted; the busiest band of the 1M
    default frame against its twin. Returns the launches."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.probes import make_scene
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.scene import load_scene

    launches = {}
    scenes = {}
    for n in (STRUCT_N, STRUCT_SMALL):
        ply = tmp / f"structured_{n}.ply"
        run_quiet(make_scene.main, [str(ply), str(n), "--device", "cuda"])
        g = load_scene(ply, device=dev)
        ref = make_scene.structured_scene_arrays(n)
        errs = {f: float(np.max(np.abs(getattr(g, f).cpu().numpy() - ref[f])
                                / np.maximum(np.abs(ref[f]), 1e-6)))
                for f in ("means", "scales", "colors", "opacities", "sh")}
        check(g.num == n and max(errs.values()) < 1e-5,
              f"structured {n}: reloaded {g.num} splats, largest relative "
              f"field error {errs}")
        say(21, f"structured scene {n}: made and written by probes."
                f"make_scene ({ply.stat().st_size / 2**20:.0f} MiB) and "
                f"reloaded, fields within {max(errs.values()):.1e} "
                f"(relative) of the generator's")
        scenes[n] = (g, ply)

    g, ply = scenes[STRUCT_N]
    cams = {"bench pose r 5": (BENCH_POSE, (4, 8)),
            "view pose r 10": (STRUCT_POSE, (4,))}
    least = {}
    for label, (pose, narrows) in cams.items():
        cam = bench_camera(FULL_RES, dev, **pose)
        for narrow in narrows:
            c = make_scene.count_summary(make_scene.candidate_counts(
                g, cam, narrow=narrow))
            least[(label, narrow)] = c
            say(21, f"structured 1M@{FULL_RES[0]}x{FULL_RES[1]}, {label}, "
                    f"bin_narrow {narrow}: candidate slots a tile (global "
                    f"list + own) max {c['max_slots']}, p99 "
                    f"{c['p99_slots']:.0f}, mean {c['mean_slots']:.1f}; "
                    f"{c['tiles_over_416']} of {c['tiles']} tiles over "
                    f"{make_scene.SMEM_SLOTS} slots (peel_fwd.cu shades "
                    f"them from device memory); global list {c['global']}; "
                    f"least clean budgets max_candidates "
                    f"{c['least_candidates']}, max_global "
                    f"{c['least_global']}")
    uni = make_scene.count_summary(make_scene.candidate_counts(
        g1m, bench_camera(FULL_RES, dev), narrow=4))
    say(21, f"the uniform 1M scene (random_scene) at the bench pose, "
            f"bin_narrow 4: max {uni['max_slots']}, p99 "
            f"{uni['p99_slots']:.0f}, mean {uni['mean_slots']:.1f} slots, "
            f"{uni['tiles_over_416']} tiles over {make_scene.SMEM_SLOTS}, "
            f"global {uni['global']}; least clean budgets "
            f"{uni['least_candidates']} / {uni['least_global']} (the "
            f"viewer's 3584 / 64)")
    view = least[("view pose r 10", 4)]
    check(view["least_global"] <= 64, f"structured 1M at the view pose: a "
          f"global list of {view['least_global']} outgrows the CLI's 64")
    budget = view["least_candidates"]

    cam = bench_camera(FULL_RES, dev, **STRUCT_POSE)
    for renderer in (None, "keys"):
        counts = struct_cli(ply, FULL_RES, renderer, budget, BANDS,
                            tmp / "s1m.npy")
        add_counts(launches, counts)
        name = renderer or "default (pallas)"
        key = "keys_sid" if renderer else "peel_fwd"
        check(counts[key] == BANDS and sum(counts.values()) == BANDS,
              f"structured 1M CLI {name}: launches {counts}, expected "
              f"{BANDS} of {key}")
        kw = dict(max_candidates=budget, tile_bands=BANDS)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            _, stats = render(g, cam, depth=DEPTH, with_stats=True,
                              renderer=renderer or "auto", **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
        dropped = int(stats["local_overflow"]) + int(stats["global_overflow"])
        w, h = FULL_RES
        say(21, f"structured 1M CLI render {name} at {w}x{h}, view pose, "
                f"max_candidates {budget} (the least clean), {BANDS} bands, "
                f"depth {DEPTH}: launches {counts}; in process peak "
                f"{peak:.2f} GiB, dropped pairs {dropped}")
        check(dropped == 0, f"structured 1M {name}: {dropped} pairs dropped "
              f"at {budget}")
        img8 = np.load(tmp / "s1m.npy")
        check(img8.shape == (h, w, 3) and img8.max() > 0,
              f"structured 1M {name}: saved frame {img8.shape}")

    # The JAX package's 250k command, and the same at its least budget.
    g250, ply250 = scenes[STRUCT_SMALL]
    cam250 = bench_camera(STRUCT_SMALL_RES, dev, **STRUCT_POSE)
    c250 = make_scene.count_summary(make_scene.candidate_counts(g250, cam250))
    renderer, jax_budget, jax_bands = JAX_STRUCT_CMD
    w, h = STRUCT_SMALL_RES
    for budget_250 in (jax_budget, c250["least_candidates"]):
        counts = struct_cli(ply250, STRUCT_SMALL_RES, renderer, budget_250,
                            jax_bands, tmp / "s250k.npy")
        add_counts(launches, counts)
        check(counts["peel_fwd"] == jax_bands, f"structured 250k CLI: "
              f"launches {counts}")
        with torch.inference_mode():
            _, stats = render(g250, cam250, depth=DEPTH, with_stats=True,
                              renderer=renderer, max_candidates=budget_250,
                              tile_bands=jax_bands)
        dropped = int(stats["local_overflow"]) + int(stats["global_overflow"])
        say(21, f"structured 250k CLI render --renderer {renderer} "
                f"--max-candidates {budget_250} --tile-bands {jax_bands} at "
                f"{w}x{h}, view pose: launches {counts}; dropped pairs "
                f"{dropped} (counts: max "
                f"{c250['max_slots']}, p99 {c250['p99_slots']:.0f}, "
                f"{c250['tiles_over_416']} of {c250['tiles']} tiles over "
                f"{make_scene.SMEM_SLOTS}, global {c250['global']})")
        if budget_250 != jax_budget:
            check(dropped == 0, f"structured 250k: {dropped} pairs dropped "
                  f"at its least budget {budget_250}")

    # The whole keys frame, kernel path against twin path, and the busiest
    # band of the default frame against its twin.
    frame_parity(g, dict(res=FULL_RES, max_candidates=budget, max_global=64,
                         bin_narrow=4), dev, cam=cam, phase=21,
                 label=f"the structured 1M scene (keys, {budget} candidates)")
    kw = dict(max_candidates=budget, max_global=64, bin_narrow=4,
              tile_bands=BANDS)
    with torch.inference_mode():
        band = fused_frame(g, cam, DEPTH, kw)[1]
    counts = band["cand"].ge(0).sum(1)
    say(21, f"structured 1M default frame: the busiest band holds "
            f"{int((counts > 416).sum())} of {counts.numel()} tiles over "
            f"{make_scene.SMEM_SLOTS} slots, longest {int(counts.max())}")
    check(band["dropped"] == 0, f"structured 1M band: dropped "
          f"{band['dropped']}")
    band_against_twin(band, 21, "the structured 1M scene's busiest band")
    return launches


def phase21_fitbench(g100k):
    """scripts/fitbench.py's protocol at its size through ``pallas`` and
    ``keys``: PSNR must rise by MIN_PSNR_RISE."""
    from rtgs_tpu_torch.probes import fitbench

    launches = {}
    for renderer in ("pallas", "keys"):
        r, counts = counted(lambda: fitbench.run(
            g100k, steps=FITBENCH_STEPS, views=FITBENCH_VIEWS,
            res=CFG_FIT["res"], depth=DEPTH,
            cand=CFG_FIT["max_candidates"], renderer=renderer,
            log=lambda m: None))
        add_counts(launches, counts)
        rise = r["last_psnr"] - r["first_psnr"]
        say(21, f"fitbench 100k@{CFG_FIT['res'][0]}x{CFG_FIT['res'][1]}, "
                f"{FITBENCH_VIEWS} views, {FITBENCH_STEPS} steps through "
                f"{renderer}: PSNR {r['first_psnr']:.2f} -> "
                f"{r['last_psnr']:.2f} dB (means over the first and last "
                f"{FITBENCH_VIEWS} steps; rise limit {MIN_PSNR_RISE:g}); "
                f"curve " + " ".join(f"{c['step']}:{c['psnr']:.2f}"
                                     for c in r["curve"])
                + f"; peak {r['peak_gib']:.2f} GiB; launches {counts}")
        check(rise >= MIN_PSNR_RISE, f"fitbench through {renderer}: PSNR "
              f"rose {rise:.3f} dB")
    return launches


def phase21_fitscratch(g100k, dev, tmp):
    """scripts/fitscratch.py's protocol: FITSCRATCH_COLLAPSE steps of it on
    the uniform box its code fits (F11, reported); on the structured scene
    the standard run (FITSCRATCH_STEPS steps through the default renderer,
    pallas on the card), its first FITSCRATCH_CUT steps again (PSNRs,
    parameters and mask bitwise), and those steps through keys; Adam's
    state checked after every step."""
    import torch

    from rtgs_tpu_torch.probes import fitscratch

    def watcher(snap=None):
        seen = {"cap": None}

        def watch(solver, m):
            for grp, p in zip(solver.optimizer.param_groups, solver.params):
                st = solver.optimizer.state.get(p, {})
                check(grp["params"][0] is p and int(st.get("step", -1))
                      == solver.step, f"step {solver.step}: Adam's group "
                      f"{grp['name']} holds another tensor, or its step "
                      f"count {st.get('step')} is not the solver's")
            cap = solver.mask.shape[0]
            if "grown" in seen:
                moved = not torch.equal(seen.pop("grown"),
                                        solver.params.means.detach())
                check(moved, f"step {solver.step}: the step after a growth "
                      f"did not update the new leaves")
            if seen["cap"] is not None and cap != seen["cap"]:
                seen["grown"] = solver.params.means.detach().clone()
            seen["cap"] = cap
            if snap is not None and solver.step == FITSCRATCH_CUT:
                snap["params"] = [p.detach().clone() for p in solver.params]
                snap["mask"] = solver.mask.clone()
        return watch

    def report(label, r, counts):
        growths = "; ".join(
            f"step {s}: {a} -> {b}" + (f" ({m['allocated_gib']:.2f} GiB "
                                       f"allocated, peak {m['peak_gib']:.2f})"
                                       if m else "")
            for (s, a, b), m in zip(r["capacity_growths"],
                                    r["growth_memory"]
                                    + [None] * len(r["capacity_growths"])))
        blown = [i + 1 for i, p in enumerate(r["psnrs"]) if not p > 0]
        say(21, f"fitscratch {label}: {r['steps']} steps, seed "
                f"{r['seed_points']} of {r['gt_n']}, {r['views']} views at "
                f"{r['res'][0]}x{r['res'][1]}: growths {growths}; "
                f"capacities {r['capacities']}; final live "
                f"{r['final_live']}, PSNR {r['final_psnr']}; curve "
                + " ".join(f"{s}:{p}/{n}" for s, p, n in r["psnr_curve"])
                + f"; peak {r['peak_gib']:.2f} GiB; dropped pairs summed "
                f"over every step {r['dropped_pairs']}; reloaded "
                f"{r['reloaded']} splats; launches {counts}; steps whose PSNR "
                f"is not positive (an f32 exponent blown up, F2): "
                f"{len(blown)} {blown[:20]}")
        # The asserts read the run up to its gate; past it the f32
        # exponent (F2) may blow up any step's image, so the tail is
        # reported above, not asserted.
        gate, views = min(FITSCRATCH_GATE, r["steps"]), r["views"]
        grown = [e for e in r["capacity_growths"] if e[0] <= gate]
        live = {s: n for s, _, n in r["psnr_curve"]}[gate]
        first = statistics.mean(r["psnrs"][:views])
        last = statistics.mean(r["psnrs"][gate - views:gate])
        say(21, f"fitscratch {label}, at step {gate}: {len(grown)} growths "
                f"by then, {live} live; mean PSNR over steps 1-{views} "
                f"{first:.2f} dB, over steps {gate - views + 1}-{gate} "
                f"{last:.2f} dB")
        check(len(grown) >= 1 and live > r["seed_points"], f"fitscratch "
              f"{label}: growths {grown}, {live} live at step {gate}")
        check(last - first >= MIN_PSNR_RISE, f"fitscratch {label}: PSNR "
              f"rose {last - first:.3f} dB by step {gate}")
        check(r["reloaded"] == r["final_live"], f"fitscratch {label}: the "
              f".ply reloaded {r['reloaded']} of {r['final_live']} splats")
        check(r["dropped_pairs"] in (0, None), f"fitscratch {label}: "
              f"{r['dropped_pairs']} pairs dropped")

    launches = {}
    box, counts = counted(lambda: fitscratch.run(
        g100k, steps=FITSCRATCH_STEPS, stop_at=FITSCRATCH_COLLAPSE,
        renderer="auto", out=str(tmp / "box.ply"), log=lambda m: None))
    add_counts(launches, counts)
    solver = box.pop("solver")
    seed_scale = float(torch.exp(fitscratch.seed_params(
        g100k, box["seed_points"])[0].log_scales[0, 0]))
    say(21, f"fitscratch as the script's code runs it (random_scene, "
            f"{FITSCRATCH_COLLAPSE} of {FITSCRATCH_STEPS} steps, auto -> "
            f"pallas): live " + " ".join(f"{s}:{n}" for s, _, n in
                                        box["psnr_curve"])
            + f", PSNR " + " ".join(f"{s}:{p}" for s, p, _ in
                                    box["psnr_curve"])
            + f"; the world-size prune at the step-100 pass is 0.1 x "
            f"{solver.scene_extent:.3f} = {0.1 * solver.scene_extent:.3f} "
            f"against the seeds' isotropic scale {seed_scale:.3f}; fault "
            f"F11, shared with the JAX package "
            f"(tests/test_torch_fitscratch.py)")
    del solver, box

    from rtgs_tpu_torch.probes import make_scene

    gt = make_scene.structured_scene(g100k.num, device=dev)
    least = [make_scene.candidate_counts(gt, cam) for cam in
             fitscratch_cameras(dev)]
    say(21, f"structured 100k ground truth, its 16 views at 512x384: least "
            f"clean budgets {max(c['least_candidates'] for c in least)} / "
            f"{max(c['least_global'] for c in least)}; the fits bin at "
            f"{FITSCRATCH_BUDGETS['cand']} / {FITSCRATCH_BUDGETS['glob']}")
    budgets = FITSCRATCH_BUDGETS
    snap = {}
    std, counts = counted(lambda: fitscratch.run(
        gt, steps=FITSCRATCH_STEPS, renderer="auto",
        out=str(tmp / "fitscratch.ply"), count_dropped=True,
        on_step=watcher(snap), log=lambda m: None, **budgets))
    add_counts(launches, counts)
    check(counts["peel_fwd"] > 0 and counts["keys_sid"] == 0,
          f"fitscratch auto: launches {counts}")
    report(f"structured (auto -> pallas, {FITSCRATCH_STEPS} steps)", std,
           counts)
    std.pop("solver")
    rep, counts = counted(lambda: fitscratch.run(
        gt, steps=FITSCRATCH_STEPS, stop_at=FITSCRATCH_CUT,
        renderer="auto", out=str(tmp / "repeat.ply"), log=lambda m: None,
        **budgets))
    add_counts(launches, counts)
    same = rep["psnrs"] == std["psnrs"][:FITSCRATCH_CUT] and all(
        torch.equal(a, b.detach()) for a, b in zip(snap["params"],
                                                    rep["solver"].params))
    same = same and torch.equal(snap["mask"], rep["solver"].mask)
    check(same, f"fitscratch: the first {FITSCRATCH_CUT} steps again are "
          f"not bitwise the standard run's")
    say(21, f"fitscratch: the first {FITSCRATCH_CUT} steps again "
            f"({len(rep['capacity_growths'])} growths in them): every PSNR, "
            f"parameter and the mask bitwise the first run's")
    del rep, snap
    keys, counts = counted(lambda: fitscratch.run(
        gt, steps=FITSCRATCH_STEPS, stop_at=FITSCRATCH_CUT,
        renderer="keys", out=str(tmp / "keys.ply"), count_dropped=True,
        on_step=watcher(), log=lambda m: None, **budgets))
    add_counts(launches, counts)
    report(f"structured, keys (the first {FITSCRATCH_CUT} steps)", keys,
           counts)
    return launches


def fitscratch_cameras(dev):
    """The 16 orbit views of the fitscratch protocol (512x384, r 5)."""
    return [bench_camera((512, 384), dev, theta=2 * math.pi * i / 16)
            for i in range(16)]


def phase21_imquality(scenes, dev):
    """The production renders (keys and auto) of the three bench
    configurations against their twins (bitwise) and against the oracle
    where it runs (IMQ_MIN_PSNR, IMQ_MIN_SSIM); the JAX package's TPU
    quality record beside them."""
    from rtgs_tpu_torch.probes import imquality
    from rtgs_tpu_torch.probes._common import BENCH_CONFIGS
    from rtgs_tpu_torch.scene import random_scene

    record = ROOT / "IMQUALITY_r05.json"
    jax_rows = (json.loads(record.read_text())["rows"]
                if record.is_file() else [])
    launches = {}
    for i, cfg in enumerate(BENCH_CONFIGS):
        g = scenes.get(cfg["n"])
        if g is None:
            g = random_scene(cfg["n"], device=dev, **BENCH_SCENE)
        out, counts = counted(lambda: imquality.run_config(
            cfg, dev, g=g, log=lambda m: None))
        add_counts(launches, counts)
        w, h = cfg["res"]
        check(out["oracle"] == (cfg["n"] * w * h <= imquality.ORACLE_LIMIT),
              f"imquality {cfg['label']}: oracle {out['oracle']}")
        for row in out["rows"]:
            twin = row["prod_vs_twin"]
            check(twin["psnr_db"] == 120.0 and twin["max_absdiff"] == 0.0,
                  f"imquality {cfg['label']} {row['row']}: production "
                  f"against twin {twin}")
            oracle = ""
            if "prod_vs_oracle" in row:
                po, to = row["prod_vs_oracle"], row["twin_vs_oracle"]
                check(po["psnr_db"] >= IMQ_MIN_PSNR
                      and po["ssim"] >= IMQ_MIN_SSIM,
                      f"imquality {cfg['label']} {row['row']}: production "
                      f"against oracle {po}")
                oracle = f"; against the oracle production {po}, twin {to}"
            say(21, f"imquality {cfg['label']} {row['row']} "
                    f"({row['renderer']}): production against twin "
                    f"{twin}{oracle}")
        if i < len(jax_rows):
            j = {k: v for k, v in jax_rows[i].items()
                 if k not in ("res", "backend")}
            say(21, f"the JAX package's record there (TPU v5e, "
                    f"IMQUALITY_r05.json; quality, not time): {j}")
        check(counts["keys_sid"] > 0 and counts["peel_fwd"] > 0,
              f"imquality {cfg['label']}: launches {counts}")
    return launches


def phase21_trace(dev, tmp):
    """scripts/trace_step.py's protocol: TRACE_STEPS traced pallas steps
    at 100k@256x256, depth 8; the summary must name the training
    kernels."""
    from rtgs_tpu_torch.probes import trace_step

    out, counts = counted(lambda: trace_step.run(
        100_000, TRACE_STEPS, str(tmp / "trace"), dev, log=lambda m: None))
    k = out["kernels"]
    say(21, f"trace_step 100k@256x256, {TRACE_STEPS} traced steps: "
            f"{out['files']} files, {out['bytes'] / 1e6:.1f} MB; device "
            f"kernels a step by group: " + ", ".join(
                f"{g} {v['kernels'] // TRACE_STEPS}" for g, v in k.items())
            + f"; launches {counts}")
    for g in ("peel_fwd", "peel_bwd", "segment_rows"):
        check(k[g]["kernels"] > 0, f"trace_step: no {g} kernel in the "
              f"trace ({k})")
    return counts


def phase21_stages(dev):
    """probes.stages at 100k@640x384 and 1M@1920x1088, both renderers:
    their binning drops nothing."""
    from rtgs_tpu_torch.probes import stages

    launches = {}
    for n, (w, h), cand, narrow, bands in (
            (100_000, (640, 384), 1536, 3, 0),
            (1_000_000, FULL_RES, 3584, 4, BANDS)):
        for renderer in ("keys", "pallas"):
            out, counts = counted(lambda: stages.stage_table(
                n, w, h, dev, cand=cand, glob=128, bands=bands,
                narrow=narrow, renderer=renderer, log=lambda m: None))
            add_counts(launches, counts)
            check(out["dropped"] == 0, f"stages {n}@{w}x{h}: dropped "
                  f"{out['dropped']}")
            say(21, f"stages {n}@{w}x{h} {renderer}, bands {bands or 1}: "
                    f"0 dropped; launches {counts}")
    return launches


def phase21_tools(g100k, g1m, dev):
    """Phase 21. Returns the launches of its main paths by kernel."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        add_counts(launches, phase21_make_scene(g1m, dev, tmp))
        add_counts(launches, phase21_fitbench(g100k))
        add_counts(launches, phase21_fitscratch(g100k, dev, tmp))
        add_counts(launches, phase21_imquality(
            {100_000: g100k, 1_000_000: g1m}, dev))
        add_counts(launches, phase21_trace(dev, tmp))
    add_counts(launches, phase21_stages(dev))
    say(21, f"launches on its main paths {launches}")
    return launches


def phase22_binning(g1m, g100k, dev):
    """Phase 22: the binning kernels bitwise the plain chain at the
    benchmark's two configurations, with both paths' arguments. Returns the
    binnings that one fused and one keys frame at 1M@1920x1088 launched."""
    import torch

    from rtgs_tpu_torch.ops.peel import CHUNK
    from rtgs_tpu_torch.render import binning as B
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.render.tiled import (entry_lower_bound,
                                             pack_features,
                                             precompute_features)

    fields = ("candidates", "counts", "local_overflow", "global_overflow",
              "chunk_lb")
    full = dict(max_candidates=4608, max_global=128)
    for label, g, res, kw in (
            ("1M@1920x1088", g1m, FULL_RES, dict(full, narrow=4)),
            ("100k@512x384", g100k, (512, 384),
             dict(max_candidates=1536, max_global=128))):
        cam = bench_camera(res, dev)
        with torch.no_grad():
            entry_lb = entry_lower_bound(
                g, cam, pack_features(precompute_features(g, cam)))
            # The fused path's arguments, then the keys path's.
            for args in (kw, dict(kw, chunk=CHUNK, entry_lb=entry_lb)):
                k = B.tile_candidates_cuda(g, cam, **args)
                p = B.tile_candidates_torch(g, cam, **args)
                for f in fields:
                    x, y = getattr(k, f), getattr(p, f)
                    same = (x is None and y is None) or (
                        x is not None and y is not None
                        and x.dtype == y.dtype and torch.equal(x, y))
                    check(same, f"binning {label} (chunk "
                                f"{args.get('chunk')}): the kernels' {f} is "
                                f"not the plain chain's")
        t, c = k.candidates.shape
        say(22, f"binning {label}: bitwise the plain chain at both paths' "
                f"arguments ({g.num} splats, {int(k.counts.sum())} live "
                f"pairs, {t}x{c} rows)")
    # The main path: one binning a frame, fused or keys.
    cam = bench_camera(FULL_RES, dev)
    frames = {}
    with torch.inference_mode():
        for renderer in ("auto", "keys"):
            B.tile_candidates_cuda.launches = 0
            render(g1m, cam, depth=DEPTH, renderer=renderer,
                   **dict(SERVE_KW, **full))
            torch.cuda.synchronize()
            frames[renderer] = B.tile_candidates_cuda.launches
            check(frames[renderer] == 1,
                  f"a render({renderer}) frame launched the binning "
                  f"{frames[renderer]} times, not once")
    say(22, f"binning launches a 1M@1920x1088 frame: {frames}")
    return sum(frames.values())


def phase23_features(g1m, dev):
    """Phase 23: the features kernels bitwise the plain chains at
    1M@1920x1088 from three orbit poses. Returns the launches of both
    kernels that one fused and one keys frame made without grad."""
    import torch

    from rtgs_tpu_torch.render import tiled as T
    from rtgs_tpu_torch.render.api import render

    for theta in (BENCH_POSE["theta"], 2.1, 4.4):
        cam = bench_camera(FULL_RES, dev, theta=theta)
        with torch.no_grad():
            packed, c0 = T.feature_table_cuda(g1m, cam)
            ref = T.precompute_features_torch(g1m, cam)
            check(same_bits(packed, T.pack_features(ref)),
                  f"features θ {theta}: the table kernel's (N+1, 64) table "
                  f"is not the plain chain's")
            check(same_bits(c0, ref.c0) and math.isinf(float(c0[-1])),
                  f"features θ {theta}: the table kernel's c0 is not the "
                  f"plain chain's (inf sentinel)")
            for offset in (None, (0.25, -0.375)):
                check(same_bits(T.pixel_table_cuda(cam, TILE, offset),
                                T.pixel_table_torch(cam, TILE, offset)),
                      f"features θ {theta}, offset {offset}: the pixel "
                      f"kernel's (T, P, 24) table is not the plain chain's")
    say(23, f"features 1M@{FULL_RES[0]}x{FULL_RES[1]}: the table kernel and "
            f"the pixel kernel bitwise the plain chains at 3 poses "
            f"({g1m.num + 1}x64 table, {tuple(ref.sh.shape)} SH, pixel "
            f"offsets none and (0.25, -0.375))")
    cam = bench_camera(FULL_RES, dev)
    frames = {}
    with torch.inference_mode():
        for renderer in ("auto", "keys"):
            before = (T.feature_table_cuda.launches,
                      T.pixel_table_cuda.launches)
            render(g1m, cam, depth=DEPTH, renderer=renderer,
                   **dict(SERVE_KW, max_candidates=4608, max_global=128))
            torch.cuda.synchronize()
            frames[renderer] = (T.feature_table_cuda.launches - before[0],
                                T.pixel_table_cuda.launches - before[1])
            check(frames[renderer] == (1, 1),
                  f"a render({renderer}) frame launched the table and pixel "
                  f"kernels {frames[renderer]} times, not once each")
    say(23, f"features launches (table, pixel) a 1M@1920x1088 frame: "
            f"{frames}")
    return sum(sum(v) for v in frames.values())


def run():
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
    say(1, f"toolchain: {toolchain_stamp(nvcc)}")

    lib_path = _build.build()
    _build.load_library()
    say(2, f"built {lib_path.name}; "
           + ptxas_summary(lib_path.with_suffix(".log").read_text()))

    from rtgs_tpu_torch.scene import random_scene

    # Launches of each hand-written kernel on its main path, by kernel.
    launches = dict.fromkeys(("keys_sid", "peel_fwd", "peel_bwd",
                              "peel_topk_fwd", "peel_topk_bwd", "probe_micro",
                              "probe_ablate", "probe_floor", "segment_rows",
                              "binning", "features"), 0)
    g100k = random_scene(CFG_100K["n"], device=dev, **BENCH_SCENE)
    case_100k = phase3_case("100k@640x384", g100k, CFG_100K, dev)
    g1m = random_scene(CFG_1M_GATE["n"], device=dev, **BENCH_SCENE)
    phase3_case("1M@256x192", g1m, CFG_1M_GATE, dev)
    frame_parity(g1m, CFG_1M_GATE, dev)
    phase3_anisotropic(dev)
    phase4_precision(case_100k)
    del case_100k

    with tempfile.TemporaryDirectory() as tmp:
        launches["keys_sid"] += phase5_main_path(g1m, dev, pathlib.Path(tmp))

    w, h = CFG_FIT["res"]
    phase6_case(f"100k@{w}x{h}", g100k, CFG_FIT, dev)
    phase6_case("1M@256x192", g1m, CFG_1M_GATE, dev)
    with tempfile.TemporaryDirectory() as tmp:
        fwd, bwd, seg = phase7_fit_cli(g100k, pathlib.Path(tmp))
    launches["peel_fwd"] += fwd
    launches["peel_bwd"] += bwd
    launches["segment_rows"] += seg
    phase8_fitbench(g100k, dev)

    for label, g, cfg in ((f"100k@{w}x{h}", g100k, CFG_FIT),
                          ("1M@256x192", g1m, CFG_1M_GATE)):
        fwd, bwd = phase9_case(label, g, cfg, dev)
        launches["peel_topk_fwd"] += fwd
        launches["peel_topk_bwd"] += bwd
    with tempfile.TemporaryDirectory() as tmp:
        ply_4k = phase10_oracle(dev, pathlib.Path(tmp))
        phase11_tiled(g100k, ply_4k, dev, pathlib.Path(tmp))

    phase12_gradients(g100k, dev)
    from rtgs_tpu_torch.probes._common import BENCH_CONFIGS

    scenes = {100_000: g100k, 1_000_000: g1m}
    for cfg in BENCH_CONFIGS:
        g = scenes.get(cfg["n"])
        if g is None:
            g = random_scene(cfg["n"], device=dev, **BENCH_SCENE)
        launches["keys_sid"] += phase12_bench(cfg, g, dev)
    del g, scenes
    with tempfile.TemporaryDirectory() as tmp:
        keys, seg = phase13_keys_cli(g100k, pathlib.Path(tmp))
    launches["keys_sid"] += keys
    launches["segment_rows"] += seg
    phase8_fitbench(g100k, dev, renderer="keys", phase=13)
    launches["probe_micro"] += phase14_kmicro(dev)
    ablate, floor = phase14_scene_probes(dev)
    launches["probe_ablate"] += ablate
    launches["probe_floor"] += floor
    launches["keys_sid"] += phase15_serve(g1m, dev)
    g4k = random_scene(ORACLE_N, device=dev, **SCENE_4K)
    keys, seg = phase16_ring(g1m, g100k, g4k, dev)
    launches["keys_sid"] += keys
    launches["segment_rows"] += seg
    phase17_bvh_profiling(g1m, g100k, dev)
    phase18_determinism(g100k, g1m, g4k, dev)
    del g4k
    deep = phase19_deep(g100k, g1m, dev)
    launches["keys_sid"] += deep["peel_keys_cuda"]
    launches["peel_fwd"] += deep["peel_fused_cuda"]
    launches["peel_bwd"] += deep["peel_fused_bwd_cuda"]
    launches["segment_rows"] += deep["segment_rows_cuda"]
    launches["peel_fwd"] += phase20_default(g1m, dev)
    add_counts(launches, phase21_tools(g100k, g1m, dev))
    launches["binning"] += phase22_binning(g1m, g100k, dev)
    launches["features"] += phase23_features(g1m, dev)
    del g1m, g100k
    check("jax" not in sys.modules and "rtgs_tpu" not in sys.modules,
          "something imported jax or the JAX package")
    for name, n in launches.items():
        check(n > 0, f"{name} was launched no time on its main path")
    say("all", f"launches of each kernel on its main path: {launches}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
