"""A closed-loop turntable: one frame in flight, frame i at θ₀ + 2π·i/F
on the orbit (φ, r) of the configuration's camera, θ₀ drawn from the seed.

Each frame builds its camera as the viewer does (``orbit_camera_pose``,
``camera_from_fov``) and calls the port's entry point,
``rtgs_tpu_torch.render.api.render(scene, camera, depth, renderer,
with_stats=True, **budgets)``, under ``torch.inference_mode()``; its time
runs from the call that asks for the frame to a synchronise after it.
Mix parameters: ``depth``, ``renderer``, ``frames_per_orbit``,
``warmup_frames`` (rendered in set-up, at the first poses),
``check_frames`` (poses whose last frame the reference judges: pose 0 and
others drawn from the seed) and ``check_within`` (the check poses lie among
the window's first frames, which every run reaches: a traced run renders
them in its untraced first stretch, so the count below stays out of its
traces).

The reference judges a kept frame's image and each pixel's number of layers
composited, which the harness reads from the layers the port's selection
launches return on the timed path (:data:`SELECTORS`), on those frames only.
"""

from __future__ import annotations

import functools
import importlib
import math
import statistics
import time

import numpy as np
import torch

from benchmark import scene as S
from benchmark import trace as T
from benchmark.reference import compare
from benchmark.reference import render as R


# The port's launchers that select a frame's layers, as module attributes
# looked up when called, and which of their outputs holds the layers
# (T, K, P), −1 where vacant: the kernels on the card, their plain twins on
# the CPU. Each band's passes share one candidates tensor (argument 1).
SELECTORS = (("rtgs_tpu_torch.ops.peel", "peel_fused_cuda", 2),
             ("rtgs_tpu_torch.ops.peel", "_fused_twin", 2),
             ("rtgs_tpu_torch.ops.peel", "peel_keys_cuda", 1),
             ("rtgs_tpu_torch.ops.peel", "peel_keys_torch", 1))


class Workload:
    unit = "frames"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.dev = config, mix, seed, device
        cam = config["camera"]
        self.res, self.fov = tuple(cam["res"]), float(cam["fov"])
        self.phi, self.r = float(cam["phi"]), float(cam["r"])
        self.depth, self.renderer = int(mix["depth"]), mix["renderer"]
        self.per_orbit = int(mix["frames_per_orbit"])
        self.budgets = dict(config["render"])
        self.budgets["tile"] = tuple(self.budgets["tile"])
        self.theta0 = S.orbit_theta0(seed)
        within = int(mix["check_within"])
        assert 1 < within <= self.per_orbit, "check_within"
        gen = S.generator(seed, "cpu", salt=3)
        others = (torch.randperm(within - 1, generator=gen) + 1)
        self.check_poses = {0, *others[:int(mix["check_frames"]) - 1]
                            .tolist()}
        # pose → (frame, image, layers composited a pixel)
        self.kept: dict[int, tuple[int, torch.Tensor, torch.Tensor]] = {}
        self.next = 0
        self._layers = None       # a kept frame's (band, layer counts)
        self._saved = []

    def theta(self, i: int) -> float:
        return self.theta0 + 2.0 * math.pi * i / self.per_orbit

    def setup(self):
        from rtgs_tpu_torch.gaussians import Gaussians

        self.fields = S.uniform_scene(self.cfg, self.seed, self.dev)
        n = self.fields["means"].shape[0]
        self.scene = Gaussians(mask=torch.ones(n, device=self.dev),
                               **self.fields)
        for mod_name, attr, at in SELECTORS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._counting(orig, at))
        for i in range(int(self.mix["warmup_frames"])):
            self._frame(i)
        _sync(self.dev)

    def _counting(self, orig, at: int):
        """``orig``, which also adds up each pixel's selected layers (T, P)
        by band while a kept frame renders."""
        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self._layers is not None:
                cand = args[1]
                key = (cand.data_ptr(), tuple(cand.shape))
                # The benchmark's own work: a traced run leaves it out.
                with torch.profiler.record_function(T.PREFIX + T.COUNT):
                    n = (out[at] >= 0).sum(1, dtype=torch.int32)
                    if self._layers and self._layers[-1][0] == key:
                        self._layers[-1][1] += n
                    else:
                        self._layers.append([key, n])
            return out

        return wrapper

    def _layer_image(self) -> torch.Tensor:
        """The kept frame's layers a pixel (W, H), from its bands' counts
        (T, P) laid out as the port lays out its tiles' radiance: tile
        tx·nty + ty, pixel a·th + b at (tx·tw + a, ty·th + b)."""
        w, h = self.res
        tw, th = self.budgets["tile"]
        ntx, nty = -(-w // tw), -(-h // th)
        n = torch.cat([c for _key, c in self._layers])
        return (n.reshape(ntx, nty, tw, th).permute(0, 2, 1, 3)
                .reshape(ntx * tw, nty * th)[:w, :h].to(torch.int16))

    def _frame(self, i: int):
        from rtgs_tpu_torch.camera import camera_from_fov
        from rtgs_tpu_torch.render.api import render
        from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

        pos, rot, _, _ = orbit_camera_pose(self.theta(i), self.phi, self.r,
                                           np.zeros(3),
                                           np.array([0.0, 0.0, 0.0, 1.0]))
        with torch.inference_mode():
            cam = camera_from_fov(pos, rot, self.res, self.fov,
                                  device=self.dev)
            return render(self.scene, cam, depth=self.depth,
                          renderer=self.renderer, with_stats=True,
                          **self.budgets)

    def run(self, seconds: float | None = None,
            units: int | None = None) -> dict:
        """Frames back to back until ``seconds`` have passed or ``units``
        frames are done. Returns the window's record."""
        times, drops = [], []
        start = time.perf_counter()
        while True:
            i = self.next
            kept = i % self.per_orbit in self.check_poses
            self._layers = [] if kept else None
            t0 = time.perf_counter()
            img, stats = self._frame(i)
            _sync(self.dev)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            drops.append(stats["local_overflow"] + stats["global_overflow"])
            if kept:
                self.kept[i % self.per_orbit] = (i, img, self._layer_image())
                self._layers = None
            self.next += 1
            if ((units is not None and len(times) >= units)
                    or (seconds is not None and t1 - start >= seconds)):
                break
        dropped = [int(d) for d in drops]
        return dict(start=start, window_s=t1 - start, times=times,
                    attempted=len(times),
                    failed=sum(1 for d in dropped if d > 0),
                    dropped_pairs=sum(dropped))

    def end_to_end(self, rec: dict) -> dict:
        w, h = self.res
        p95 = statistics.quantiles(rec["times"], n=100)[94] \
            if len(rec["times"]) > 1 else rec["times"][0]
        return {"mrays_per_s": w * h * rec["attempted"] / rec["window_s"]
                / 1e6,
                "frame_p95_ms": p95 * 1e3}

    def release(self):
        """Free the program's state and put its launchers back; the inputs
        and the kept frames stay."""
        self.scene = None
        for mod, attr, orig in reversed(self._saved):
            if hasattr(orig, "launches"):
                orig.launches = getattr(mod, attr).launches
            setattr(mod, attr, orig)
        self._saved = []

    def _ref_camera(self, i: int) -> R.Camera:
        o, axes = S.orbit_pose(self.theta(i), self.phi, self.r)
        return R.Camera(o, axes, self.res, self.fov)

    def check(self, rec: dict) -> dict:
        """The kept frames against the reference's: the worst tile's image
        error and gap of layers composited; the check poses the window did
        not reach; the pairs dropped."""
        errs, gaps = [], []
        for _pose, (i, img, layers) in sorted(self.kept.items()):
            ref, ref_layers = R.frame(self.fields, self._ref_camera(i),
                                      self.depth)
            errs.append(compare.tile_err_max(img, ref))
            gaps.append(compare.winners_gap(layers, ref_layers, self.depth))
        return {"tile_err_max": max(errs, default=math.inf),
                "winners_gap": max(gaps, default=math.inf),
                "poses_unchecked": float(len(self.check_poses)
                                         - len(self.kept)),
                "dropped_pairs": float(rec["dropped_pairs"])}

    def control(self, dtype=torch.bfloat16) -> dict:
        """The control: the reference in ``dtype`` in the program's place,
        at the check poses, judged as the program's frames are."""
        self.fields = S.uniform_scene(self.cfg, self.seed, self.dev)
        errs, gaps = [], []
        for p in sorted(self.check_poses):
            low = R.frame(self.fields, self._ref_camera(p), self.depth, dtype)
            ref = R.frame(self.fields, self._ref_camera(p), self.depth)
            errs.append(compare.tile_err_max(low[0], ref[0]))
            gaps.append(compare.winners_gap(low[1], ref[1], self.depth))
        return {"tile_err_max": max(errs), "winners_gap": max(gaps)}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
