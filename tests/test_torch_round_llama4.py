"""The round rows of llama4-maverick-400b-a17b against the JAX package's
round (the MoE FFN with top-1 routing), with the flash-attention op on and
off; the witness of the ``llama4-kernel`` row (ROADMAP C7); the driver.
Split from ``tests/test_torch_round.py`` so that ``--dist loadfile`` gives
these rows a worker of their own; the helpers are that file's.  The
witness comes right after the kernel row, so the two share the JAX step's
compile.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import _check_round, _close, _drive, _rounds, _tol_ratio


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("llama4-maverick-400b-a17b", False, {}),
    ("llama4-maverick-400b-a17b", True, {}),
], ids=["llama4-plain", "llama4-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


def test_llama4_kernel_gap_is_a_router_near_tie(monkeypatch):
    """Why the ``llama4-kernel`` row of ``test_round_matches_jax`` misses
    1e-4 (ROADMAP C7): from round 1 on, d_loss and the device state are
    off by far more than roundoff, because one token's top-1 router choice
    differs between the packages.  llama4 routes each token to one expert,
    so a flip swaps that token's whole FFN output.

    Witnesses, on the row's data:
    - round 0 agrees at 1e-4 on both losses and every leaf;
    - in the first round whose d_loss misses 1e-4 (round 1), a token's two
      best router probabilities are a few float32 ulps apart, so the
      packages' last-bit differences after round 0 (a few hundredths of
      the tolerance) decide its expert;
    - each round the port runs from the JAX state it starts from agrees
      with JAX's at 1e-4 on both losses and every leaf: the port computes
      every round as the reference does.
    """
    from repro_torch.models import mlp as tmlp
    arch, route = "llama4-maverick-400b-a17b", tmlp._top_k_route
    margins = []       # per routing call: the top two probabilities

    def record(params, cfg, xt):
        with torch.no_grad():
            probs = torch.softmax(xt.float() @ params["router"].float(), -1)
            margins.append(torch.sort(probs, -1, descending=True)[0][:, :2])
        return route(params, cfg, xt)
    monkeypatch.setattr(tmlp, "_top_k_route", record)
    by_round = []
    for r, tm, jm, tstate, jstate in _rounds(arch, True, {}):
        top2 = torch.cat(margins)
        margins.clear()
        gap = top2[:, 0] - top2[:, 1]
        live = gap > 0                  # exact ties are the zero ring rows
        i = int(torch.argmin(torch.where(live, gap, np.inf)))
        p = np.float32(top2[i, 0])
        by_round.append((_tol_ratio(tm["d_loss"], jm["d_loss"]),
                         float(gap[i]) / float(np.spacing(p))))
        if r == 0:
            _close(tm, jm, "round 0 metrics")
            _close(tstate, jstate, "round 0 state")
    monkeypatch.undo()
    resynced = list(_rounds(arch, True, {}, resync=(0, 1)))
    for r, tm, jm, tstate, jstate in resynced:
        _close(tm, jm, f"round {r} metrics from the JAX state")
        _close(tstate, jstate, f"round {r} state from the JAX state")
    print("per round: d_loss gap x TOL, the nearest router tie in ulps of "
          f"its top probability: {by_round}")
    missed = [ulps for gap, ulps in by_round if gap > 1.0]
    if missed:                           # the round where the row misses
        assert missed[0] <= 4.0          # holds a tie within a few ulps


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b"])
def test_driver_runs_moe_archs(arch):
    """The MoE arch through ``train.main``, with churn: the load-balance
    loss is in both losses, which stay finite."""
    out = _drive(arch, "--p-drop", "0.5")
    assert "we_down" in out["state"]["srv"]["blocks"][0]["ffn"]
