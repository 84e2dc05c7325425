"""The port's examples (``examples/*_torch.py``) and the batch specs the
quickstart reads (``fedopt_step.train_input_specs``,
``concrete_train_batch``), against the JAX package's.

``heterogeneous_cluster_torch`` must print what the JAX example prints,
byte for byte (both run in-process here); the quickstart and the
federated-LM driver run on the CPU, the driver for the fewest rounds at
which its own check that the server learned holds, into a snapshot that
the port's store verifies.
"""
import contextlib
import importlib.util
import io
import math
import runpy
from pathlib import Path

import pytest
import torch

from repro.configs import registry as jreg
from repro.core import fedopt_step as JF
from repro_torch.checkpoint.store import verify_snapshot
from repro_torch.configs import registry as treg
from repro_torch.core import fedopt_step as TF

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORTED = ("quickstart_torch", "federated_lm_torch",
          "heterogeneous_cluster_torch")
#: the fewest rounds at which federated_lm_torch's check holds on the CPU
LM_ROUNDS = 5
SPEC = dict(l_split=1, n_groups=4, seq_len=1024, per_group_batch=8, H=4)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_heterogeneous_cluster_prints_the_jax_example():
    jax_out = _stdout(lambda: runpy.run_path(
        str(EXAMPLES / "heterogeneous_cluster.py"), run_name="__main__"))
    port = _example("heterogeneous_cluster_torch")
    assert _stdout(lambda: port.main(["--device", "cpu"])) == jax_out


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_train_input_specs_match_jax(arch):
    """Keys and shapes the JAX package's, int64 where it has int32, all on
    the meta device."""
    want = JF.train_input_specs(JF.FedStepConfig(arch=jreg.get(arch),
                                                 **SPEC))
    got = TF.train_input_specs(TF.FedStepConfig(arch=treg.get(arch), **SPEC))
    assert list(got) == list(want)
    dtypes = {"int32": torch.int64, "float32": torch.float32}
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert got[k].dtype == dtypes[s.dtype.name], k
        assert got[k].device.type == "meta", k


def test_concrete_train_batch_draws_from_the_generator():
    cfg = TF.FedStepConfig(arch=treg.smoke_config("llama-3.2-vision-90b"),
                           l_split=1, n_groups=2, seq_len=16,
                           per_group_batch=4, H=2, omega=2)
    draw = lambda seed: TF.concrete_train_batch(
        torch.Generator().manual_seed(seed), cfg)
    a, b, c = draw(7), draw(7), draw(8)
    assert set(a) == set(TF.train_input_specs(cfg))
    for k in ("tokens", "labels"):
        assert a[k].dtype == torch.int64
        assert 0 <= int(a[k].min()) and int(a[k].max()) < cfg.arch.vocab
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["frontend"].dtype == cfg.param_dtype
    for k in TF.PER_GROUP_KEYS:
        assert torch.equal(a[k], torch.ones(cfg.n_groups))
    # the slot indices stay host values: the step reads them with no sync
    assert a["read_slot"].device.type == "cpu"
    assert a["read_slot"].tolist() == [0, 1]


def test_quickstart_runs_eight_finite_rounds():
    qs = _example("quickstart_torch")
    out = {}
    text = _stdout(lambda: out.update(h=qs.main(["--device", "cpu"])))
    rounds = [line for line in text.splitlines() if line.startswith("round")]
    assert len(rounds) == len(out["h"]) == qs.ROUNDS == 8
    assert all(math.isfinite(m[k]) for m in out["h"]
               for k in ("d_loss", "s_loss"))
    assert rounds[-1].endswith("global version 8")


def test_federated_lm_learns_and_writes_a_verified_snapshot(tmp_path):
    lm = _example("federated_lm_torch")
    ckpt = tmp_path / "ckpt"
    out = lm.main(["--rounds", str(LM_ROUNDS), "--ckpt-every",
                   str(LM_ROUNDS), "--ckpt-dir", str(ckpt), "--device",
                   "cpu"])
    h = out["history"]
    assert len(h) == LM_ROUNDS and h[-1]["s_loss"] < h[0]["s_loss"]
    assert verify_snapshot(str(ckpt), LM_ROUNDS) == (True, "")


@pytest.mark.parametrize("name", PORTED)
def test_example_device_defaults_to_cuda(name):
    assert _example(name).build_parser().parse_args([]).device == "cuda"
