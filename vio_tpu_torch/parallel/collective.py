"""The one collective of the distributed LM loops: a rank's reduced system
summed over a ``torch.distributed`` group in float64 on the wire.  Shared by
global BA (``parallel/global_ba.py``) and the window split
(``solver/lm.py`` under ``parallel/sharded.py``)."""
from __future__ import annotations

import torch
import torch.distributed as dist


def _psum_hi(x, group, op=dist.ReduceOp.SUM):
    """All-reduce over ``group`` (None: one process, x as it is) in float64
    on the wire (the JAX package's x64 path of ``_psum_hi``): with float32
    partials the reduction order moved the LM accept decisions at 262k
    observations (SCALING.md, r4), so the partials are widened before they
    meet.  Under gloo the payload is reduced through host memory: it is
    copied to the host, reduced there and copied back, whatever device the
    ranks use."""
    if group is None:
        return x
    wire = x.to(torch.float64)
    if dist.get_backend(group) == dist.Backend.GLOO and wire.is_cuda:
        host = wire.cpu()
        dist.all_reduce(host, op=op, group=group)
        wire = host.to(x.device)
    else:
        dist.all_reduce(wire, op=op, group=group)
    return wire.to(x.dtype)


def all_reduce_system(S, rhs, chi, extra, group, wire: list):
    """ONE all_reduce of a rank's reduced system: S (P, P), rhs (P,), chi²
    () and ``extra`` (k,) packed into one float64 payload.  Returns their
    sums over ``group`` (None: one process, the inputs as they are);
    appends the payload's bytes to ``wire``."""
    if group is None:
        return S, rhs, chi, extra
    P = S.shape[0]
    packed = _psum_hi(torch.cat([S.reshape(-1), rhs, chi[None], extra]), group)
    wire.append(8 * packed.numel())
    return (packed[:P * P].reshape(P, P), packed[P * P:P * P + P],
            packed[P * P + P], packed[P * P + P + 1:])
