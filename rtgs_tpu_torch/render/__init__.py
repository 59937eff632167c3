from rtgs_tpu_torch.render.api import (ProgressiveSampler, render,
                                       render_progressive)
from rtgs_tpu_torch.render.tiled import render_tiled_keys

__all__ = ["ProgressiveSampler", "render", "render_progressive",
           "render_tiled_keys"]
