"""The check fails what it must: the timed path broken underneath the
harness, and each cell's precision control, read ``correct`` false."""
import numpy as np
import pytest
import torch

from _small import run_cell


def _frame_step_fault(monkeypatch, how):
    from vio_tpu_torch.solver import frame_step
    orig = frame_step.frame_step

    def broken(states, *args, **kw):
        out = orig(states, *args, **kw)
        dev, dt = kw["device"], kw["dtype"]
        if how == "unchanged":
            st = type(out.states)(*[torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
                                    for x in states])
        else:   # the newest frame's position altered where it is produced
            Ps = out.states.Ps.clone()
            Ps[-1] += 0.05
            st = out.states._replace(Ps=Ps)
        return out._replace(states=st)
    monkeypatch.setattr(frame_step, "frame_step", broken)


@pytest.mark.parametrize("how", ["unchanged", "altered"])
def test_broken_frame_step_is_not_correct(monkeypatch, how):
    out = run_cell("sim_features", 2 ** 31 + 201,
                   patch=lambda run: _frame_step_fault(monkeypatch, how))
    assert out["correct"] is False
    assert out["check"]["window_cost_left"]["value"] > out["check"]["window_cost_left"]["limit"]


def _prior_fault(monkeypatch, how):
    from vio_tpu_torch.solver import frame_step, marginalize
    if how in ("marg_bp", "no_shift"):
        orig = frame_step.frame_step

        def broken(states, *args, **kw):
            out = orig(states, *args, **kw)
            if how == "marg_bp":    # the marginalization's right-hand side altered
                return out._replace(marg_bp=out.marg_bp * 1.01)
            # the solve's first-order shift of the prior's right-hand side left out
            return out._replace(b_prior=torch.as_tensor(args[13], dtype=kw["dtype"]))
        monkeypatch.setattr(frame_step, "frame_step", broken)
        return
    orig = marginalize.finalize_old_from_blocks

    def chain(H, b):
        if how == "chain_b_dropped":
            Hp, bp, errp, Jtp = orig(H, b)
            return Hp, np.zeros_like(bp), np.zeros_like(errp), Jtp
        # the wrong frame eliminated
        P = np.asarray(H).shape[0]
        perm = marginalize._perm_np(P, 1)
        return marginalize._finalize_np(np.asarray(H)[perm][:, perm], np.asarray(b)[perm], P)
    monkeypatch.setattr(marginalize, "finalize_old_from_blocks", chain)


@pytest.mark.parametrize("how, number", [("marg_bp", "marg_b_gap"),
                                         ("no_shift", "prior_shift_gap"),
                                         ("chain_b_dropped", "prior_chain_gap"),
                                         ("wrong_frame", "prior_chain_gap")])
def test_broken_prior_is_not_correct(monkeypatch, how, number):
    out = run_cell("sim_features", 2 ** 31 + 204,
                   patch=lambda run: _prior_fault(monkeypatch, how))
    assert out["correct"] is False
    assert out["check"][number]["value"] > out["check"][number]["limit"]


def test_control_is_not_correct():
    out = run_cell("sim_features", 2 ** 31 + 203, control=True)
    assert out["correct"] is False
    n = out["check"]
    for k in ("marg_H_gap", "marg_b_gap", "prior_chain_gap"):
        assert n[k]["value"] > n[k]["limit"], k
