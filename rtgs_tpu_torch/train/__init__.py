"""Training: losses, the optimization loop and its datasets (port of
:mod:`rtgs_tpu.train`)."""

from rtgs_tpu_torch.train.loss import l1_loss, psnr, render_loss, ssim
from rtgs_tpu_torch.train.solver import (
    SceneParams,
    Solver,
    activate,
    init_params,
    init_params_from_points,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
    shard_params,
)

__all__ = [
    "l1_loss",
    "psnr",
    "ssim",
    "render_loss",
    "SceneParams",
    "Solver",
    "activate",
    "init_params",
    "init_params_from_points",
    "make_optimizer",
    "make_sharded_train_step",
    "make_train_step",
    "shard_params",
]
