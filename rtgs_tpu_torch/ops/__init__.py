from rtgs_tpu_torch.ops.peel import peel_keys

__all__ = ["peel_keys"]
