"""Where the port's device work runs, and in what precision.

The rule of the port: an entry point runs on the card unless its caller
asks for the CPU.  ``resolve`` is the one place that rule lives.
"""
from __future__ import annotations

import torch


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    """``device=None`` is the current CUDA device and raises without one;
    anything else is taken as given (``"cpu"`` is what a machine without
    a card, and every CPU test, passes).  ``dtype=None`` is float32 on
    CUDA and float64 on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vio_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is false: pass device=\"cpu\" to "
                "run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    return device, dtype


def move(nt, device, dtype):
    """A NamedTuple of tensors (nested ones too) on ``device``, its
    floating tensors in ``dtype``; fields that are neither (static
    configuration) stay as they are.  Nothing is copied that is already
    there."""
    def one(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return move(x, device, dtype)
        if not isinstance(x, torch.Tensor):
            return x
        return x.to(device, dtype) if x.is_floating_point() else x.to(device)
    return type(nt)(*(one(x) for x in nt))
