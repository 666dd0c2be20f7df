"""What the harness takes from the program: its counters, and the inputs
and outputs of the calls that the judges check, recorded as the window
drives them.  A recorder's records live under its own name in
``Run.recorded``, apart from every other recorder's.

``FrameSteps`` wraps the program's frame step (the card's graphed entry
and the CPU's eager one) with a recorder that, while the window is open,
offers every call to a seed-drawn sample (``core.Sampler``, one for
keyframe steps and one for the others) and keeps the
host arrays that the call was handed and returned, by reference: the
estimator builds them anew each frame.  A sampled call also keeps the
prior that the next call is handed (``next_prior``): what the
estimator's host chain made of this call's outputs.  The wrapper calls
the program's function unchanged.

``PoseGraphSolves`` wraps the loop closer's pose-graph solve the same
way (``loop.posegraph.optimize``, the module attribute that
``LoopCloser`` calls): while the window is open it offers every solve to
a seed-drawn sample and keeps what the solve was handed and returned,
unpadded, as host float64 copies.
"""
from __future__ import annotations

import inspect

from benchmark.harness.core import Sampler

PRIOR = ("H_prior", "b_prior", "err_prior", "Jt_prior_inv")
ARGS = ("states", "dts", "accs", "gyrs", "mask", "acc0", "gyr0", "imu_valid",
        "pts_i", "pts_j", "start", "obs_mask", "feat_valid", "H_prior", "b_prior",
        "err_prior", "Jt_prior_inv", "g", "noise", "sqrt_info")


def counters() -> dict:
    """The program's counters: the graph cache's and the solve kernel's
    launches."""
    from vio_tpu_torch.ops import linsolve
    from vio_tpu_torch.solver import graph
    st = graph.STATS
    return dict(captures=st["captures"], keys=st["keys"], replays=st["replays"],
                gj_solves=linsolve.gj_solve.launches)


def _host(x):
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


class FrameSteps:
    """Half of the ``k`` sampled frame steps are keyframe steps (the
    oldest frame marginalized), half the others, each drawn from its own
    kind.  Their records go under "frame_steps" in ``Run.recorded``."""

    def __init__(self, k: int, seed: int):
        self.sample = {True: Sampler(k - k // 2, seed), False: Sampler(k // 2, seed + 1)}
        self.active = False
        self._saved = None
        self._pending = None   # the sampled record that waits for the next prior

    def install(self) -> None:
        from vio_tpu_torch.solver import frame_step
        self._saved = (frame_step.frame_step_graphed, frame_step.frame_step)
        graphed, eager = self._saved

        def record(args, kw, out):
            if self._pending is not None:
                inp = dict(zip(ARGS, args))
                self._pending["next_prior"] = {k: _host(inp[k]) for k in PRIOR}
                self._pending = None
            if not self.active:
                return

            def make():
                inp = dict(zip(ARGS, args))
                inp["states"] = {k: _host(v) for k, v in inp["states"]._asdict().items()}
                for k in ARGS[1:]:
                    inp[k] = _host(inp[k])
                inp.update(fix_ext=kw["fix_ext"], marg_old=kw["marg_old"],
                           exact_noise=kw["exact_noise"], max_iter=kw["max_iter"])
                outs = dict(states={k: _host(v) for k, v in out.states._asdict().items()},
                            marg_Hpp=_host(out.marg_Hpp), marg_bp=_host(out.marg_bp),
                            b_prior=_host(out.b_prior))
                self._pending = dict(inputs=inp, outputs=outs)
                return self._pending
            self.sample[bool(kw["marg_old"])].offer(make)

        def graphed_rec(*args, **kw):
            out = graphed(*args, **kw)
            record(args, kw, out)
            return out

        def eager_rec(*args, **kw):
            out = eager(*args, **kw)
            record(args, kw, out)
            return out

        frame_step.frame_step_graphed = graphed_rec
        frame_step.frame_step = eager_rec

    def uninstall(self) -> None:
        if self._saved is not None:
            from vio_tpu_torch.solver import frame_step
            frame_step.frame_step_graphed, frame_step.frame_step = self._saved
            self._saved = None

    @property
    def records(self) -> list:
        return self.sample[True].items + self.sample[False].items


class PoseGraphSolves:
    """``k`` of the window's pose-graph solves, drawn from the seed.  A
    record: ``inputs`` (Ps0, qs0, ei, ej, dP, dq, w: the edge weights, 1
    where the call gave none; fix_first, max_iter) and ``outputs`` (Ps,
    qs: the solved poses; iterations).  They go under "posegraph" in
    ``Run.recorded``."""

    def __init__(self, k: int, seed: int):
        self.sample = Sampler(k, seed)
        self.active = False
        self._saved = None

    def install(self) -> None:
        import numpy as np
        from vio_tpu_torch.loop import posegraph
        optimize = self._saved = posegraph.optimize
        sig = inspect.signature(optimize)

        def optimize_rec(*args, **kw):
            out = optimize(*args, **kw)
            if not self.active:
                return out

            def make():
                a = sig.bind(*args, **kw)
                a.apply_defaults()
                a = a.arguments
                w = a["edge_weights"]
                inp = dict(Ps0=_f64(a["Ps0"]), qs0=_f64(a["qs0"]),
                           ei=np.array(a["edges_i"], np.int64),
                           ej=np.array(a["edges_j"], np.int64),
                           dP=_f64(a["edges_dP"]), dq=_f64(a["edges_dq"]),
                           w=np.ones(len(a["edges_i"])) if w is None else _f64(w),
                           fix_first=bool(a["fix_first"]), max_iter=int(a["max_iter"]))
                return dict(inputs=inp, outputs=dict(Ps=_f64(out[0]), qs=_f64(out[1]),
                                                     iterations=out[2].get("iterations")))
            self.sample.offer(make)
            return out

        posegraph.optimize = optimize_rec

    def uninstall(self) -> None:
        if self._saved is not None:
            from vio_tpu_torch.loop import posegraph
            posegraph.optimize = self._saved
            self._saved = None

    @property
    def records(self) -> list:
        return self.sample.items


def _f64(x):
    """A host float64 copy."""
    import numpy as np
    return np.array(_host(x), dtype=np.float64)


def release() -> None:
    """Free the program's device state: the graph cache and its pools."""
    import gc

    import torch
    from vio_tpu_torch.solver import graph
    graph.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
