"""Pytrees of tensors (tuples and NamedTuples of tensors), as the LM loops'
carries hold them."""
from __future__ import annotations

import torch


def select(mask, new, old):
    """``torch.where(mask, new, old)`` leaf by leaf over two pytrees of one
    structure."""
    if isinstance(old, tuple):
        out = [select(mask, n, o) for n, o in zip(new, old)]
        return type(old)(*out) if hasattr(old, "_fields") else tuple(out)
    return torch.where(mask, new, old)
