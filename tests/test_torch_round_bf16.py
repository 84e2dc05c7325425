"""The bfloat16 round rows against the JAX package's round: smoke
smollm-135m with ``param_dtype`` bfloat16 in both packages, held at the
reference's bfloat16 tolerance, 2e-2, with the flash-attention op on and
off; their witness (ROADMAP C6).  Split from ``tests/test_torch_round.py``
so that ``--dist loadfile`` gives these rows a worker of their own; the
helpers are that file's.  The witness takes the kernel row first, right
after that row, so the two share the JAX step's compile.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_round import BF16_TOL, _check_round, _close, _f32, _rounds


@pytest.mark.parametrize("arch,use_kernel,opts", [
    ("smollm-135m", False, dict(param_dtype="bfloat16")),
    ("smollm-135m", True, dict(param_dtype="bfloat16")),
], ids=["bf16-plain", "bf16-kernel"])
def test_round_matches_jax(arch, use_kernel, opts):
    _check_round(arch, use_kernel, opts)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["bf16-kernel", "bf16-plain"])
def test_bf16_ring_acts_gap_is_bfloat16_roundoff(use_kernel):
    """Why the ``bf16-plain`` and ``bf16-kernel`` rows of
    ``test_round_matches_jax`` miss the reference's bfloat16 tolerance,
    2e-2, on one leaf (ROADMAP C6): the ring's acts, from round 0 on.

    Witnesses, on the rows' data:
    - both losses and every other state leaf agree at 2e-2 in all three
      rounds;
    - the port against itself, with one bfloat16 ulp added to every
      element of the init's device embed and nothing else changed, moves
      the ring's acts further than the gap to the JAX round, every round:
      bfloat16 keeps 8 bits, and the two packages round in different
      places (XLA keeps a fused chain of elementwise ops in float32 and
      rounds once; torch rounds after each op), so the acts carry
      bfloat16's own rounding through the device half's updates.
    """
    opts = dict(param_dtype="bfloat16")

    def ulp_up(state):
        e = state["dev"]["embed"]
        e.copy_(torch.nextafter(e, torch.full_like(e, np.inf)))

    def ratio(got, want):
        want = _f32(want)
        return float(np.max(np.abs(got - want)
                            / (BF16_TOL + BF16_TOL * np.abs(want))))
    ulp_run = list(_rounds("smollm-135m", use_kernel, opts, perturb=ulp_up))
    for (r, tm, jm, tstate, jstate), ulp in zip(
            _rounds("smollm-135m", use_kernel, opts), ulp_run):
        _close(tm, jm, f"round {r} metrics", BF16_TOL)
        gap = ratio(tstate["act_buf"]["acts"], jstate["act_buf"]["acts"])
        moved = ratio(ulp[3]["act_buf"]["acts"], tstate["act_buf"]["acts"])
        del tstate["act_buf"]["acts"], jstate["act_buf"]["acts"]
        _close(tstate, jstate, f"round {r} state but the ring's acts",
               BF16_TOL)
        print(f"round {r}: ring acts port vs JAX {gap:.3f} x tol; port vs "
              f"port with one bf16 ulp on the init embed {moved:.3f} x tol")
        assert moved > 1.0 and moved > gap
