"""State carried across from the JAX package: numpy ↔ the port's tuples.

The port has no learned weights; what crosses between the two packages is
solver state, factor data and configuration.  The JAX side turns its
arrays into numpy (``np.asarray``) and keys them by its ``NamedTuple``
field names; these functions build the port's tuples from such dicts and
back, so the port itself never imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import VioConfig
from .factors import ImuFactorTerms
from .features.direct import DirectBAProblem
from .parallel.global_ba import GlobalBA
from .solver.bal import BalProblem
from .solver.window import WindowFactors, WindowStates


def to_tensor(x, device, dtype) -> torch.Tensor:
    """A host array as a tensor on ``device``: floats take ``dtype``,
    integers become int64 indices, booleans stay boolean."""
    a = np.array(x)   # a writable copy: JAX's buffers come back read-only
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _from_dict(cls, d: dict, device, dtype, nested=None):
    if not isinstance(d, dict) or set(d) != set(cls._fields):
        keys = set(d) if isinstance(d, dict) else set()
        raise KeyError(f"{cls.__name__}: missing {sorted(set(cls._fields) - keys)}, "
                       f"unknown {sorted(keys - set(cls._fields))}")
    return cls(**{k: nested[k](v) if nested and k in nested
                  else to_tensor(v, device, dtype) for k, v in d.items()})


def window_states_from_numpy(d: dict, *, device, dtype) -> WindowStates:
    """WindowStates from numpy arrays keyed by its field names."""
    return _from_dict(WindowStates, d, device, dtype)


def window_factors_from_numpy(d: dict, *, device, dtype) -> WindowFactors:
    """WindowFactors from numpy arrays keyed by its field names; the
    ``imu_terms`` entry is a dict keyed by ImuFactorTerms' fields."""
    terms = lambda t: _from_dict(ImuFactorTerms, t, device, dtype)  # noqa: E731
    return _from_dict(WindowFactors, d, device, dtype, nested={"imu_terms": terms})


def global_ba_from_numpy(d: dict, *, device, dtype) -> GlobalBA:
    """GlobalBA from numpy arrays keyed by its field names."""
    return _from_dict(GlobalBA, d, device, dtype)


def bal_problem_from_numpy(d: dict, *, device, dtype) -> BalProblem:
    """BalProblem from numpy arrays keyed by its field names."""
    return _from_dict(BalProblem, d, device, dtype)


def direct_problem_from_numpy(d: dict, *, device, dtype) -> DirectBAProblem:
    """DirectBAProblem from numpy arrays keyed by its field names; ``K``,
    the static (fx, fy, cx, cy), stays a tuple of floats."""
    K = lambda k: tuple(float(v) for v in k)  # noqa: E731
    return _from_dict(DirectBAProblem, d, device, dtype, nested={"K": K})


def to_numpy(x):
    """The inverse: a tensor → numpy; a NamedTuple → dict of its fields;
    tuples, lists and dicts element-wise; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_numpy(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def config_from_dict(d: dict) -> VioConfig:
    """VioConfig from a dict of its fields (``dataclasses.asdict`` of
    either package's config); sequences become the tuples the frozen
    dataclass holds."""
    names = {f.name for f in dataclasses.fields(VioConfig)}
    extra = set(d) - names
    if extra:
        raise KeyError(f"VioConfig: unknown fields {sorted(extra)}")
    return VioConfig(**{k: tuple(v) if isinstance(v, (list, tuple, np.ndarray))
                        else v for k, v in d.items()})
