"""3DGS optimization loop (port of :mod:`rtgs_tpu.train.solver`).

  * raw (pre-activation) parameters in a :class:`SceneParams` tuple, the
    exact inverse of the loader's activations, so an optimized scene
    round-trips through ``save_scene``;
  * a differentiable forward through the renderer ``auto`` resolves to
    (:func:`training_renderer`, the rule of ``render``): the fused-payload
    renderer (:func:`~rtgs_tpu_torch.render.tiled.render_tiled_pallas`,
    whose backward is the hand-written Hopper kernel on the card), the
    keys path (:func:`~rtgs_tpu_torch.render.tiled.render_tiled_keys`), or
    the oracle or the ``tiled`` renderer (torch autograd); Adam with the
    standard per-parameter-group 3DGS learning rates as ``torch.optim.Adam``
    parameter groups;
  * adaptive density control with static capacity: clone/split/prune
    rewrite masked slots on the host between steps, with the JAX package's
    numpy code and random stream (``np.random.default_rng(step)``), so both
    packages split identically;
  * checkpoints of params, mask, step and optimizer state with
    ``torch.save``.

The parameters are updated in place (``optimizer.step()``); a capacity
change replaces each parameter tensor and carries its Adam moments over.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.train.loss import psnr, render_loss
from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

def training_renderer(renderer: str, num: int, device) -> str:
    """The renderer a training step on a scene of ``num`` splats on
    ``device`` uses: the one :func:`render` renders
    (:func:`~rtgs_tpu_torch.render.api.resolve_renderer`), so ``auto`` is
    the oracle at 4096 splats or fewer, else the fused-payload path
    (``pallas``, its backward the hand-written kernel) on a CUDA device and
    ``tiled`` elsewhere, as in the JAX package. ``pallas`` and ``keys``
    train through their hand-written backwards; ``oracle`` and ``tiled``
    through torch autograd of their plain code, as they train through JAX
    autodiff."""
    from rtgs_tpu_torch.render.api import resolve_renderer

    return resolve_renderer(renderer, num, device)


class SceneParams(NamedTuple):
    """Raw optimizable parameters (pre-activation): ``scales =
    exp(log_scales)``, ``colors = sigmoid(color_logits)``, ``opacities =
    sigmoid(opacity_logits)``, ``quats`` normalized."""

    means: torch.Tensor           # (N, 3)
    quats: torch.Tensor           # (N, 4) raw, normalized on activation
    log_scales: torch.Tensor      # (N, 3)
    color_logits: torch.Tensor    # (N, 3)
    opacity_logits: torch.Tensor  # (N,)
    sh: torch.Tensor              # (N, 15, 3)


def activate(params: SceneParams, mask: torch.Tensor) -> G.Gaussians:
    """Raw params → renderable scene (the loader's activations)."""
    quats = params.quats / torch.linalg.norm(params.quats, dim=-1,
                                             keepdim=True)
    return G.Gaussians(
        means=params.means,
        quats=quats,
        scales=torch.exp(params.log_scales),
        colors=torch.sigmoid(params.color_logits),
        opacities=torch.sigmoid(params.opacity_logits),
        sh=params.sh,
        mask=mask,
    )


def _logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p) - torch.log1p(-p)


def init_params(g: G.Gaussians) -> SceneParams:
    """Inverse-activate an existing scene into raw parameters."""
    eps = 1e-6
    return SceneParams(
        means=g.means,
        quats=g.quats,
        log_scales=torch.log(torch.clamp(g.scales, min=1e-30)),
        color_logits=_logit(torch.clamp(g.colors, eps, 1 - eps)),
        opacity_logits=_logit(torch.clamp(g.opacities, eps, 1 - eps)),
        sh=g.sh,
    )


def init_params_from_points(points: torch.Tensor,
                            colors: Optional[torch.Tensor] = None
                            ) -> SceneParams:
    """Fresh initialization from a point cloud (the fit-from-scratch
    path): isotropic scales from the median nearest-neighbour distance of
    the first 512 points, opacity 0.1. (The JAX signature's leading PRNG
    key is unused there and dropped here.)"""
    points = points.to(torch.float32)
    n, dev = points.shape[0], points.device
    sub = points[: min(n, 512)]
    d2 = torch.sum((sub[:, None] - sub[None, :]) ** 2, -1)
    d2 = torch.where(d2 > 0, d2, torch.inf)
    nn = torch.sort(torch.sqrt(torch.amin(d2, dim=-1))).values
    m = nn.shape[0]
    median = (nn[(m - 1) // 2] + nn[m // 2]) / 2
    scale = torch.clamp(median, 1e-4, 1.0)
    if colors is None:
        colors = torch.full((n, 3), 0.5, device=dev)
    eps = 1e-6
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 3] = 1.0
    return SceneParams(
        means=points,
        quats=quats,
        log_scales=torch.log(scale).expand(n, 3).clone(),
        color_logits=_logit(torch.clamp(colors.to(torch.float32), eps,
                                        1 - eps)),
        opacity_logits=torch.full((n,), float(np.log(0.1 / 0.9)),
                                  device=dev),
        sh=torch.zeros((n, G.NUM_SH_COEFFS, 3), device=dev),
    )


def make_optimizer(cfg: TrainConfig,
                   params: SceneParams) -> torch.optim.Adam:
    """Per-parameter-group Adam (3DGS standard recipe, eps 1e-15): one
    group per :class:`SceneParams` field, in field order. The
    implementation is pinned to what torch picks by default today (the
    multi-tensor ``foreach`` one for CUDA parameters, the single-tensor
    one elsewhere; never ``fused``), so a step on one card and a step on a
    mesh's shard (:func:`make_sharded_train_step`) update each row with
    the same operations whatever torch's default becomes."""
    lrs = dict(means=cfg.lr_means, quats=cfg.lr_quats,
               log_scales=cfg.lr_scales, color_logits=cfg.lr_colors,
               opacity_logits=cfg.lr_opacities, sh=cfg.lr_sh)
    return torch.optim.Adam(
        [{"params": [p], "lr": lrs[name], "name": name}
         for name, p in zip(SceneParams._fields, params)], eps=1e-15,
        foreach=params.means.device.type == "cuda", fused=False)


def _make_step(cfg: TrainConfig, optimizer: torch.optim.Optimizer,
               render_fn):
    """The step of :func:`make_train_step` around ``render_fn(scene,
    camera) → image``."""

    def step(params: SceneParams, mask: torch.Tensor, camera: Camera,
             target: torch.Tensor) -> dict:
        dev = mask.device
        optimizer.zero_grad(set_to_none=True)
        with span("fit.forward", dev):
            img = render_fn(activate(params, mask), camera)
        with span("fit.loss", dev):
            loss = render_loss(img, target, cfg.lambda_dssim)
        with span("fit.backward", dev):
            loss.backward()
            for p in params:
                # optax updates every group each step, zero gradients
                # included.
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "psnr": psnr(img.detach(), target),
                       "grad_means_norm": torch.linalg.norm(
                           params.means.grad, dim=-1)}
        with span("fit.adam", dev):
            optimizer.step()
        return metrics

    return step


def make_train_step(cfg: TrainConfig, optimizer: torch.optim.Optimizer,
                    depth: int = 16, renderer: str = "auto",
                    **render_kwargs):
    """Build the training step.

    Returns ``step(params, mask, camera, target) → metrics``: it renders,
    back-propagates the loss through the renderer and updates ``params`` in
    place with ``optimizer``. ``renderer`` is resolved on each step's scene
    (:func:`training_renderer`). ``metrics`` holds the loss and PSNR (0-d
    tensors) and the per-Gaussian positional gradient norms the density
    controller consumes."""
    from rtgs_tpu_torch.render.api import render

    return _make_step(cfg, optimizer, lambda g, cam: render(
        g, cam, depth=depth,
        renderer=training_renderer(renderer, g.num, g.device),
        **render_kwargs))


def shard_params(params: SceneParams, mask: torch.Tensor, mesh):
    """This rank's shard of a scene's raw parameters and mask: rows
    ``[p·m, (p+1)·m)`` for prims-rank p (the rows
    :func:`~rtgs_tpu_torch.parallel.render.shard_scene` gives it), as
    fresh leaves on the mesh's device. Every rank passes the same whole
    scene, whose N must divide by the prims axis: build it from
    ``pad_scene(g, mesh.n_prims)``, as the one-card step of the same scene
    would. Returns (SceneParams, mask)."""
    n = mask.shape[0]
    if n % mesh.n_prims:
        raise ValueError(f"{n} splats do not divide over {mesh.n_prims} "
                         "prims-ranks: pad the scene first (pad_scene)")
    m = n // mesh.n_prims
    lo = mesh.prims_rank * m
    return (SceneParams(*(_leaf(p[lo:lo + m].to(mesh.device))
                          for p in params)),
            mask[lo:lo + m].to(mesh.device).detach().clone())


def make_sharded_train_step(cfg: TrainConfig,
                            optimizer: torch.optim.Optimizer, mesh,
                            depth: int = 16, **render_kwargs):
    """The training step on a (rays, prims) mesh (port of the step of the
    JAX package's ``__graft_entry__.dryrun_multichip``): each rank holds
    its shard's raw parameters (:func:`shard_params`) and ``optimizer``
    over them (:func:`make_optimizer`). ``step(params, mask, camera,
    target) → metrics`` activates the shard, renders the whole image on
    every rank with
    :func:`~rtgs_tpu_torch.parallel.render.render_tiled_sharded`
    (``render_kwargs``: its budgets), takes :func:`render_loss` against
    the whole target, back-propagates and takes one Adam step on the
    shard. ``metrics``: the loss and PSNR (the same on every rank) and the
    shard's per-Gaussian positional gradient norms.

    The ring's gradient is one card's bit for bit, so after k steps each
    shard's parameters and Adam moments are those rows of k one-card steps
    of :func:`make_train_step` ``(renderer="keys")`` on the padded scene
    with the same budgets. No density control runs on the mesh (nor in
    the JAX package)."""
    from rtgs_tpu_torch.parallel.render import render_tiled_sharded

    return _make_step(cfg, optimizer, lambda g, cam: render_tiled_sharded(
        g, cam, mesh, depth=depth, **render_kwargs))


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


@dataclasses.dataclass
class Solver:
    """Training orchestrator: camera cycling, adaptive density control
    over the padded capacity, opacity resets, checkpoints. ``params`` are
    copied into leaf tensors the optimizer owns; ``targets`` are (W, H, 3)
    arrays or tensors, moved to the parameters' device once."""

    params: SceneParams
    mask: torch.Tensor
    cfg: TrainConfig
    cameras: Sequence[Camera]
    targets: Sequence
    depth: int = 16
    renderer: str = "auto"
    render_kwargs: dict = dataclasses.field(default_factory=dict)
    capacity_multiple: int = 256

    def __post_init__(self):
        dev = self.params.means.device
        self.params = SceneParams(*(_leaf(p) for p in self.params))
        self.mask = torch.as_tensor(self.mask).to(
            dev, torch.float32).detach().clone()
        self.targets = [
            (t if isinstance(t, torch.Tensor)
             else torch.from_numpy(np.asarray(t, np.float32)))
            .to(dev, torch.float32).clone() for t in self.targets]
        self.optimizer = make_optimizer(self.cfg, self.params)
        self.step_fn = make_train_step(
            self.cfg, self.optimizer, self.depth, self.renderer,
            **self.render_kwargs)
        self.step = 0
        self._grad_accum = np.zeros(self.mask.shape[0], np.float32)
        self._grad_count = np.zeros(self.mask.shape[0], np.int32)
        self.scene_extent = float(np.percentile(np.linalg.norm(
            self.params.means.detach().cpu().numpy(), axis=-1), 90))

    @property
    def num_live(self) -> int:
        return int(self.mask.sum())

    def scene(self) -> G.Gaussians:
        return activate(self.params, self.mask)

    def train_step(self) -> dict:
        """One step on the next view, then the density pass and the
        opacity reset where they are due. Under a profiler the step is one
        ``fit.step`` span, the top of its phases' spans; ``fit.readback``
        is the host's wait for the step's numbers."""
        dev = self.mask.device
        with span("fit.step", dev):
            i = self.step % len(self.cameras)
            metrics = self.step_fn(self.params, self.mask, self.cameras[i],
                                   self.targets[i])
            with span("fit.readback", dev):
                gn = metrics["grad_means_norm"].cpu().numpy()
                out = {k: float(v) for k, v in metrics.items()
                       if v.ndim == 0}
            self._grad_accum += gn
            # Visibility-weighted stats (3DGS recipe): a Gaussian's densify
            # signal averages only over steps where it received gradient.
            self._grad_count += (gn > 0).astype(np.int32)
            self.step += 1

            c = self.cfg
            if (c.densify_every and c.densify_from <= self.step
                    <= c.densify_until and self.step % c.densify_every == 0):
                self.densify_and_prune()
            if (c.opacity_reset_every
                    and self.step % c.opacity_reset_every == 0):
                self.reset_opacity()
            return out

    # ----- adaptive density control (host-side, static capacity) -----

    def _host_params(self) -> SceneParams:
        return SceneParams(*(p.detach().cpu().numpy().copy()
                             for p in self.params))

    def densify_and_prune(self):
        c = self.cfg
        mask0 = self.mask.cpu().numpy().astype(bool)
        grad_avg = self._grad_accum / np.maximum(self._grad_count, 1)
        self._grad_accum[:] = 0
        self._grad_count[:] = 0

        host = self._host_params()
        opac = 1 / (1 + np.exp(-host.opacity_logits))
        scales = np.exp(host.log_scales)
        max_scale = scales.max(-1)

        prune = mask0 & ((opac < c.prune_opacity)
                         | (max_scale > c.prune_max_scale
                            * self.scene_extent))
        dense_limit = c.percent_dense * self.scene_extent
        hot = mask0 & ~prune & (grad_avg > c.densify_grad_threshold)
        clone = hot & (max_scale <= dense_limit)
        split = hot & (max_scale > dense_limit)

        needed = int(clone.sum() + split.sum())
        free_after_prune = int((~mask0).sum() + prune.sum())
        if needed > free_after_prune:
            self._grow(needed - free_after_prune)

        # Snapshot the (possibly grown) state into mutable numpy arrays.
        params = self._host_params()
        mask = self.mask.cpu().numpy().astype(bool)
        mask[: len(prune)][prune] = False
        free = np.nonzero(~mask)[0]
        rng = np.random.default_rng(self.step)
        touched = np.zeros(mask.shape[0], bool)   # slots whose Adam moments
        touched[: len(prune)][prune] = True       # must be re-zeroed

        def copy_rows(dst_slots, src_idx):
            for f in params._fields:
                getattr(params, f)[dst_slots] = getattr(params, f)[src_idx]
            mask[dst_slots] = True
            touched[dst_slots] = True

        # Clone: duplicate in place.
        idx = np.nonzero(clone)[0]
        slots, free = free[: len(idx)], free[len(idx):]
        copy_rows(slots, idx)

        # Split: two children sampled inside the parent, scales / 1.6.
        idx = np.nonzero(split)[0]
        slots, free = free[: len(idx)], free[len(idx):]
        touched[idx] = True  # split parents are rewritten in place too
        if len(idx):
            q = params.quats[idx]
            q = q / np.linalg.norm(q, axis=-1, keepdims=True)
            r = quat.as_rotation_mat3(torch.from_numpy(q)).numpy()
            copy_rows(slots, idx)
            for tgt in (slots, idx):
                # Children and parents both start from the parent's mean.
                noise = rng.normal(size=(len(idx), 3)) * scales[idx]
                params.means[tgt] = (
                    params.means[idx]
                    + np.einsum("nij,nj->ni", r, noise)).astype(np.float32)
                params.log_scales[tgt] = (
                    params.log_scales[idx] - np.log(1.6)
                ).astype(np.float32)

        with torch.no_grad():
            for p, host_p in zip(self.params, params):
                p.copy_(torch.from_numpy(host_p))
        self.mask = torch.from_numpy(mask.astype(np.float32)).to(
            self.mask.device)
        # Per-slot Adam moments: zero only the touched rows (new children,
        # split parents, pruned slots); every untouched Gaussian keeps its
        # momentum.
        self._zero_opt_rows(touched)
        logger.info(
            "densify@%d: %d clones, %d splits, %d pruned, live=%d",
            self.step, int(clone.sum()), int(split.sum()),
            int(prune.sum()), self.num_live)

    def _zero_opt_rows(self, touched: np.ndarray):
        rows = torch.from_numpy(touched).to(self.mask.device)
        for p in self.params:
            state = self.optimizer.state.get(p)
            for key in ("exp_avg", "exp_avg_sq"):
                if state and key in state:
                    state[key][rows] = 0.0

    def _grow(self, min_extra: int):
        """Grow capacity to the next multiple of ``capacity_multiple``, at
        least +50%; new slots are dead (mask 0, opacity logit −10, identity
        rotation) and their Adam moments zero."""
        cap = self.mask.shape[0]
        m = self.capacity_multiple
        new_cap = -(-max(cap + min_extra, cap + cap // 2) // m) * m
        pad = new_cap - cap
        logger.info("growing capacity %d → %d", cap, new_cap)

        def pad_rows(x, fill=0.0):
            return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                            dtype=x.dtype, device=x.device)])

        grown = []
        for group, name, p in zip(self.optimizer.param_groups,
                                  SceneParams._fields, self.params):
            new = pad_rows(p.detach(),
                           -10.0 if name == "opacity_logits" else 0.0)
            if name == "quats":
                new[cap:, 3] = 1.0
            new.requires_grad_(True)
            state = self.optimizer.state.pop(p, None)
            group["params"][0] = new
            if state:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[key] = pad_rows(state[key])
                self.optimizer.state[new] = state
            grown.append(new)
        self.params = SceneParams(*grown)
        self.mask = pad_rows(self.mask)
        self._grad_accum = np.pad(self._grad_accum, (0, pad))
        self._grad_count = np.pad(self._grad_count, (0, pad))

    def reset_opacity(self):
        """Clamp opacities down (3DGS recipe: combats floaters). Only the
        opacity group's Adam state is reset (its next step starts fresh, as
        after optax's init); every other group keeps its moments."""
        with torch.no_grad():
            self.params.opacity_logits.clamp_(
                max=float(np.log(0.01 / 0.99)))
        self.optimizer.state.pop(self.params.opacity_logits, None)

    # ----- checkpointing (torch.save) -----

    @staticmethod
    def checkpoint_path(directory, step: int) -> pathlib.Path:
        return pathlib.Path(directory) / f"step_{step}.pt"

    def save_checkpoint(self, directory):
        path = self.checkpoint_path(directory, self.step)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({
            "params": {f: p.detach().cpu()
                       for f, p in zip(SceneParams._fields, self.params)},
            "mask": self.mask.cpu(),
            "step": self.step,
            "opt": self.optimizer.state_dict(),
        }, path)

    def restore_checkpoint(self, directory, step: int):
        dev = self.mask.device
        state = torch.load(self.checkpoint_path(directory, step),
                           map_location=dev, weights_only=True)
        self.params = SceneParams(*(_leaf(state["params"][f])
                                    for f in SceneParams._fields))
        for group, p in zip(self.optimizer.param_groups, self.params):
            group["params"][0] = p
        self.optimizer.load_state_dict(state["opt"])
        self.mask = state["mask"].to(dev)
        self.step = int(state["step"])
        cap = self.mask.shape[0]
        self._grad_accum = np.zeros(cap, np.float32)
        self._grad_count = np.zeros(cap, np.int32)

    def train(self, num_steps: Optional[int] = None, log_every: int = 50):
        """Run the loop; returns the last step's metrics. Each step touches
        the fail-fast launcher's heartbeat file (a no-op without one)."""
        from rtgs_tpu_torch.parallel.launcher import touch_heartbeat

        num_steps = num_steps or self.cfg.iterations
        for _ in range(num_steps):
            metrics = self.train_step()
            touch_heartbeat()
            if self.step % log_every == 0:
                logger.info(
                    "step %d: loss=%.5f psnr=%.2f live=%d",
                    self.step, metrics["loss"], metrics["psnr"],
                    self.num_live)
            if (self.cfg.checkpoint_every
                    and self.step % self.cfg.checkpoint_every == 0):
                try:
                    self.save_checkpoint(self.cfg.checkpoint_dir)
                except OSError:  # a full or missing disk must not end a run
                    logger.exception("checkpoint at step %d failed",
                                     self.step)
        return metrics
