"""The launch path every kernel wrapper shares: the input checks and the
call into the kernels' library (``_build``).

A wrapper's host time is paid on every launch, so the good path does little:
the checks read attributes and build a message only when they fail, the C
function is resolved once (the first call builds and loads the library),
pointers and the stream go in as plain Python ints against the declared
``argtypes``, and the C side switches the device only when another one is
current. Nothing here falls back: a wrong input raises ``ValueError`` before
the launch, a refused launch raises ``RuntimeError`` after it.
"""

from __future__ import annotations

import torch

# The current stream's handle as an int, without building a Stream object.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def check_tensors(who: str, specs) -> torch.device:
    """``specs``: (name, tensor, dtype, shape or None) of every input; all
    must be contiguous CUDA tensors on the device of the first. Returns that
    device; raises ``ValueError`` otherwise (a tensor's own fault before the
    device's kind, so that each is reported on any machine)."""
    dev = specs[0][1].device
    for name, x, dtype, shape in specs:
        if x.device != dev:
            raise ValueError(f"{who}: {name} is on {x.device}, not {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{who}: {name} is {x.dtype}, want {dtype}")
        if shape is not None and x.shape != shape:
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                             f"want {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{who}: needs CUDA tensors, got {dev}")
    return dev


class Launcher:
    """One ``extern "C"`` launcher of the kernels' library.

    ``launcher(dev, *args)`` calls it on ``dev``'s current stream with
    ``args`` (ints, floats, and pointers as ``tensor.data_ptr()`` or None)
    followed by the device index and the stream, and raises
    ``RuntimeError`` if the launch was refused. The function is bound at the
    first call; ``fn`` and ``lib`` are plain attributes so that a probe can
    time the call alone."""

    def __init__(self, symbol: str, what: str):
        self.symbol, self.what = symbol, what
        self.lib = self.fn = None

    def bind(self):
        from rtgs_tpu_torch.ops import _build

        self.lib = _build.load_library()
        self.fn = getattr(self.lib, self.symbol)
        return self.fn

    def __call__(self, dev: torch.device, *args) -> None:
        fn = self.fn or self.bind()
        index = dev.index
        if index is None:
            index = torch.cuda.current_device()
        stream = (_raw_stream(index) if _raw_stream is not None
                  else torch.cuda.current_stream(index).cuda_stream)
        err = fn(*args, index, stream)
        if err:
            raise RuntimeError(
                f"{self.what} kernel launch failed: "
                f"{self.lib.rtgs_cuda_error_string(err).decode()}")
