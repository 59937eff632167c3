"""Configuration dataclasses (port of :mod:`rtgs_tpu.config`, with the same
fields and defaults): rendering, scene loading, the (rays, prims) mesh and
training (the 3DGS paper's standard recipe). The JAX package's
``KernelConfig`` holds the TPU kernels' A/B options and has no counterpart
here."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class RenderConfig:
    """Rendering parameters (the CLI's ``-r``, ``-f``, ``-s``, ``-d``,
    ``--renderer``, ``--max-candidates``, ``--bin-narrow``)."""

    res: Tuple[int, int] = (960, 540)  # (W, H)
    fov: float = 90.0                  # vertical FOV, degrees
    sample: int = 1                    # samples (identical without jitter)
    depth: int = 16                    # composited layers per ray
    renderer: str = "auto"
    tile: Tuple[int, int] = (16, 16)   # pixel tile (W, H) of the tile paths
    max_candidates: int = 512          # per-tile candidate list width
    # Narrow-class fan-out width in tiles of the binning (None → 4).
    bin_narrow: Optional[int] = None


@dataclasses.dataclass
class SceneConfig:
    """Scene loading. ``bvh_nodes`` is the CLI's ``-v`` (flag parity): the
    LBVH (:mod:`rtgs_tpu_torch.bvh`) has single-splat leaves, and nothing
    on the render path traverses it."""

    path: Optional[str] = None
    scale: float = 1.0
    sh_layout: str = "inria"
    bvh_nodes: int = 1024


@dataclasses.dataclass
class MeshConfig:
    """Process mesh: the rays axis (tiles data-parallel) × the prims axis
    (splats sharded, ring pass); :mod:`rtgs_tpu_torch.parallel.mesh`."""

    rays: int = 1
    prims: int = 1


@dataclasses.dataclass
class TrainConfig:
    """3DGS optimization loop hyperparameters."""

    iterations: int = 7000
    lr_means: float = 1.6e-4
    lr_quats: float = 1e-3
    lr_scales: float = 5e-3
    lr_colors: float = 2.5e-3
    lr_sh: float = 2.5e-3 / 20
    lr_opacities: float = 5e-2
    lambda_dssim: float = 0.2
    # Adaptive density control.
    densify_from: int = 500
    densify_until: int = 15000
    densify_every: int = 100
    densify_grad_threshold: float = 2e-4
    opacity_reset_every: int = 3000
    prune_opacity: float = 5e-3
    # Prune splats whose max scale exceeds this fraction of the scene
    # extent (the 3DGS world-size prune): a runaway splat that inflates
    # after densification stops can otherwise never be removed.
    prune_max_scale: float = 0.1
    percent_dense: float = 0.01
    # Checkpointing.
    checkpoint_every: int = 1000
    checkpoint_dir: str = "checkpoints"


@dataclasses.dataclass
class Config:
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
