"""Training configuration (port of :class:`rtgs_tpu.config.TrainConfig`,
with the same fields and defaults: the 3DGS paper's standard recipe)."""

from __future__ import annotations

import dataclasses


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
