"""The recovery re-fit (the protocol of the port's ``probes/fitbench.py``
and the JAX package's ``scripts/fitbench.py``): the seed's scene is the
ground truth, its ``views`` orbit views (θ = 2π·v/views, the camera's φ and
r) the targets, rendered by the port in set-up; the means, log-scales and
color logits are perturbed by σ·z, z standard normal from the seed, and
``Solver.train_step()`` re-fits them, cycling the views in order, with the
density pass and the opacity reset off, so every step is the same work.
With ``clamp_log_scales`` the perturbed log-scales are clamped into the
configuration's ``scale_range``: the start is then a scene of the ground
truth's own law, and no seed draws a splat flatter than that law allows.
Unclamped, the noise's tail draws splats far flatter than the law's, and
on some seeds one of them, in the first view, alone decides the first
gradient's gap: the port's float32 form of a hit cancels on flat splats.

Set-up drives the solver through its first ``check_steps`` steps (the
reference follows them) and on to ``warmup_steps``; the window then calls
``train_step()`` back to back. Mix parameters: ``views``, ``depth``,
``renderer``, ``noise`` (field → σ), ``lr`` (field → learning rate),
``lambda_dssim``, ``train`` (further ``TrainConfig`` fields),
``clamp_log_scales``, ``check_steps``, ``warmup_steps``.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from benchmark import scene as S
from benchmark.reference import compare
from benchmark.reference import render as R
from benchmark.reference import train as T


class Workload:
    unit = "steps"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.dev = config, mix, seed, device
        cam = config["camera"]
        self.res, self.fov = tuple(cam["res"]), float(cam["fov"])
        self.phi, self.r = float(cam["phi"]), float(cam["r"])
        self.views, self.depth = int(mix["views"]), int(mix["depth"])
        self.budgets = dict(config["render"])
        self.budgets["tile"] = tuple(self.budgets["tile"])

    def theta(self, v: int) -> float:
        return 2.0 * math.pi * v / self.views

    def raw_start(self) -> dict:
        """The perturbed raw parameters (float32, on the run's device)."""
        f = self.fields
        gen = S.generator(self.seed, self.dev, salt=4)
        z = {k: torch.randn(f[src].shape, generator=gen, dtype=torch.float32,
                            device=self.dev)
             for k, src in (("means", "means"), ("log_scales", "scales"),
                            ("color_logits", "colors"))}
        raw = dict(means=f["means"], quats=f["quats"],
                   log_scales=torch.log(f["scales"]),
                   color_logits=torch.logit(f["colors"]),
                   opacity_logits=torch.logit(f["opacities"]), sh=f["sh"])
        start = {k: v + self.mix["noise"][k] * z[k] if k in z else v
                 for k, v in raw.items()}
        if self.mix.get("clamp_log_scales", False):
            lo, hi = self.cfg["scene"]["scale_range"]
            start["log_scales"] = start["log_scales"].clamp(math.log(lo),
                                                            math.log(hi))
        return start

    def setup(self):
        from rtgs_tpu_torch.camera import camera_from_fov
        from rtgs_tpu_torch.config import TrainConfig
        from rtgs_tpu_torch.gaussians import Gaussians
        from rtgs_tpu_torch.render.api import render
        from rtgs_tpu_torch.train.solver import SceneParams, Solver
        from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

        self.fields = S.uniform_scene(self.cfg, self.seed, self.dev)
        n = self.fields["means"].shape[0]
        mask = torch.ones(n, device=self.dev)
        gt = Gaussians(mask=mask, **self.fields)
        cams, targets = [], []
        for v in range(self.views):
            pos, rot, _, _ = orbit_camera_pose(
                self.theta(v), self.phi, self.r, np.zeros(3),
                np.array([0.0, 0.0, 0.0, 1.0]))
            cams.append(camera_from_fov(pos, rot, self.res, self.fov,
                                        device=self.dev))
            with torch.inference_mode():
                targets.append(render(gt, cams[-1], depth=self.depth,
                                      renderer=self.mix["renderer"],
                                      **self.budgets).clone())
        self.raw0 = self.raw_start()
        lr = self.mix["lr"]
        cfg = TrainConfig(lr_means=lr["means"], lr_quats=lr["quats"],
                          lr_scales=lr["log_scales"],
                          lr_colors=lr["color_logits"],
                          lr_opacities=lr["opacity_logits"], lr_sh=lr["sh"],
                          lambda_dssim=self.mix["lambda_dssim"],
                          **self.mix["train"])
        self.solver = Solver(
            params=SceneParams(**{k: self.raw0[k] for k in T.LEAVES}),
            mask=mask, cfg=cfg, cameras=cams, targets=targets,
            depth=self.depth, renderer=self.mix["renderer"],
            render_kwargs=self.budgets)
        self.first = self._first_steps(int(self.mix["check_steps"]))
        for _ in range(int(self.mix["warmup_steps"])
                       - int(self.mix["check_steps"])):
            self.solver.train_step()
        _sync(self.dev)

    def _first_steps(self, n: int) -> dict:
        """The solver's first ``n`` steps, read as the reference's are: each
        loss, each leaf's first gradient as Adam holds it after step 1
        (exp_avg / (1 − β₁)), and each leaf's change after the ``n``."""
        s = self.solver
        before = [p.detach().clone() for p in s.params]
        losses, grads = [], None
        for _ in range(n):
            losses.append(s.train_step()["loss"])
            if grads is None:
                beta1 = s.optimizer.param_groups[0]["betas"][0]
                # A step that kept no state reads as no gradient.
                grads = {k: float(torch.linalg.norm(s.optimizer.state[p].get(
                    "exp_avg", torch.zeros(())).double()) / (1 - beta1))
                    for k, p in zip(T.LEAVES, s.params)}
        change = {k: float(torch.linalg.norm(p.detach().double()
                                             - b.double()))
                  for k, p, b in zip(T.LEAVES, s.params, before)}
        return dict(losses=losses, grad_norms=grads, change_norms=change)

    @contextlib.contextmanager
    def _drops(self, out: list):
        """Keep each binning's dropped-pair counters (device scalars; read
        after the window)."""
        import rtgs_tpu_torch.render.tiled as tiled

        orig = tiled.tile_candidates

        def counted(*args, **kwargs):
            b = orig(*args, **kwargs)
            out.append(b.local_overflow + b.global_overflow)
            return b

        tiled.tile_candidates = counted
        try:
            yield
        finally:
            tiled.tile_candidates = orig

    def run(self, seconds: float | None = None,
            units: int | None = None) -> dict:
        times, losses, drops = [], [], []
        with self._drops(drops):
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                losses.append(self.solver.train_step()["loss"])
                _sync(self.dev)
                t1 = time.perf_counter()
                times.append(t1 - t0)
                if ((units is not None and len(times) >= units)
                        or (seconds is not None and t1 - start >= seconds)):
                    break
        dropped = [int(d) for d in drops]
        bad = sum(1 for x in losses if not math.isfinite(x))
        return dict(start=start, window_s=t1 - start, times=times,
                    attempted=len(times), failed=bad + sum(
                        1 for d in dropped if d > 0),
                    dropped_pairs=sum(dropped))

    def end_to_end(self, rec: dict) -> dict:
        return {"step_ms": rec["window_s"] / rec["attempted"] * 1e3}

    def release(self):
        self.solver = None

    def _ref_cameras(self, n: int):
        out = []
        for v in range(n):
            o, axes = S.orbit_pose(self.theta(v), self.phi, self.r)
            out.append(R.Camera(o, axes, self.res, self.fov))
        return out

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's first steps from the same start, in ``dtype``,
        against its own renders of the targets in that dtype."""
        n = int(self.mix["check_steps"])
        cams = self._ref_cameras(n)
        targets = [R.render(self.fields, c, self.depth, dtype) for c in cams]
        return T.steps(self.raw0, targets, cams, self.depth, self.mix["lr"],
                       self.mix["lambda_dssim"], n, dtype)

    def check(self, rec: dict) -> dict:
        ref = self.reference()
        for key in ("losses", "grad_norms", "change_norms"):
            print(f"{key}: program {self.first[key]} reference {ref[key]}",
                  file=sys.stderr)
        per_leaf = {}
        out = compare.train_gaps(self.first, ref, per_leaf)
        print(f"leaf gaps (first gradient, change): {per_leaf}",
              file=sys.stderr)
        out["dropped_pairs"] = float(rec["dropped_pairs"])
        return out

    def control(self, dtype=torch.bfloat16) -> dict:
        """The control: the reference in ``dtype`` in the program's place,
        judged as the program's first steps are (each leaf's gaps too)."""
        self.fields = S.uniform_scene(self.cfg, self.seed, self.dev)
        self.raw0 = self.raw_start()
        per_leaf = {}
        out = compare.train_gaps(self.reference(dtype), self.reference(),
                                 per_leaf)
        for k, (g, c) in per_leaf.items():
            out[f"grad_gap.{k}"], out[f"change_gap.{k}"] = g, c
        return out


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
