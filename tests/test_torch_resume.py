"""The port's pod driver saves and resumes (``launch/train.run_pod`` with
``--ckpt-dir``): 4 rounds unbroken against 2 rounds and a rerun of the
same command to 4, at windows 1 and 2, with and without ``--ckpt-flush``,
under churn (``--p-drop 0.3``) and under a fleet trace with selection —
the resumed histories and final state equal the unbroken run's bit for
bit.  A torn newest snapshot makes the rerun fall back to the previous
one and say so; a snapshot's ring refuses another ``--omega``.  Tiny
smollm on the CPU (G=4, batch 4, H=2, seq 16).
"""
import json
import os

import pytest
import torch

from repro_torch.faults import tear_snapshot
from repro_torch.launch import train
from repro_torch.models.common import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ["--device", "cpu", "--batch", "4", "--H", "2", "--seq-len", "16",
        "--groups-per-shard", "4", "--ckpt-every", "2"]
CHURN = ["--p-drop", "0.3"]
FLEET = ["--fleet-trace", "weibull", "--selection", "refl:0.5"]


def _run(d, rounds, *flags, crash_at=None):
    """``train.main`` with ``--ckpt-dir d``; with ``crash_at`` the run
    dies as round ``crash_at`` (0-based) drains, a crash of the same
    command, whose snapshots stay."""
    argv = ARGS + ["--rounds", str(rounds), "--ckpt-dir", str(d), *flags]
    if crash_at is None:
        return train.main(argv)
    args = train.build_parser().parse_args(argv)

    def on_round(r, m):
        if r == crash_at:
            raise Crash(r)
    args.on_round = on_round
    with pytest.raises(Crash):
        train.run_pod(args)
    return None


class Crash(Exception):
    pass


def _assert_same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _retained_in_snapshots(d) -> int:
    n = 0
    for name in os.listdir(d):
        with open(os.path.join(d, name, "tree.json")) as f:
            man = json.load(f)
        n += len(man["metadata"]["control_plane"]["retention"]["versions"])
        assert bool(man.get("extra_keys")) == bool(
            man["metadata"]["control_plane"]["retention"]["versions"])
    return n


def _resume_equals_unbroken(tmp_path, flags, capsys, crash=False):
    """4 rounds unbroken against 2 rounds and a rerun to 4 — or, with
    ``crash``, against the 4-round command dying in round 3 and rerun."""
    unbroken = _run(tmp_path / "unbroken", 4, *flags)
    if crash:
        _run(tmp_path / "resumed", 4, *flags, crash_at=2)
    else:
        first = _run(tmp_path / "resumed", 2, *flags)
        assert first["history"] == unbroken["history"][:2]
    capsys.readouterr()
    rest = _run(tmp_path / "resumed", 4, *flags)
    assert "resumed from round 2" in capsys.readouterr().out
    assert rest["history"] == unbroken["history"][2:]
    _assert_same_state(rest["state"], unbroken["state"])
    assert sorted(os.listdir(tmp_path / "resumed")) == \
        sorted(os.listdir(tmp_path / "unbroken")) == \
        ["step_00000002", "step_00000004"]
    return unbroken, rest


@pytest.mark.parametrize("window,flush,crash", [
    (1, False, False), (2, False, False), (1, True, False), (2, True, False),
    (2, False, True)])
def test_resume_equals_the_unbroken_run_under_churn(tmp_path, capsys,
                                                    window, flush, crash):
    flags = CHURN + ["--window", str(window)] + \
        (["--ckpt-flush"] if flush else [])
    unbroken, _ = _resume_equals_unbroken(tmp_path, flags, capsys,
                                          crash=crash)
    saves = unbroken["executor"]["checkpoints"]
    assert saves == ({"flush_saves": 2, "noflush_saves": 0} if flush
                     else {"flush_saves": 0, "noflush_saves": 2})
    assert unbroken["executor"]["retention"]["retired"] > 0
    assert _retained_in_snapshots(tmp_path / "resumed") > 0


def test_resume_equals_the_unbroken_run_under_a_fleet_and_selection(
        tmp_path, capsys):
    """The trace's horizon is ``--rounds``, so the first run is the same
    4-round command, crashed in round 3."""
    unbroken, rest = _resume_equals_unbroken(tmp_path, FLEET, capsys,
                                             crash=True)
    assert unbroken["fleet"]["cohorts"][2:] == rest["fleet"]["cohorts"]
    assert unbroken["fleet"]["cohorts"] != unbroken["fleet"]["available"]
    with open(tmp_path / "resumed" / "step_00000002" / "tree.json") as f:
        assert "selection_rng" in json.load(f)["metadata"]


def test_torn_newest_snapshot_falls_back_to_the_previous(tmp_path, capsys):
    unbroken = _run(tmp_path / "unbroken", 6, *CHURN)
    _run(tmp_path / "resumed", 4, *CHURN)
    tear_snapshot(str(tmp_path / "resumed"), 4, "bitflip")
    capsys.readouterr()
    rest = _run(tmp_path / "resumed", 6, *CHURN)
    out = capsys.readouterr().out
    assert "resume: skipping torn snapshot step 4: " in out
    assert "resumed from round 2" in out
    assert rest["history"] == unbroken["history"][2:]
    _assert_same_state(rest["state"], unbroken["state"])


def test_resume_refuses_another_omega(tmp_path):
    _run(tmp_path, 2)
    with pytest.raises(ValueError, match="ω=1 activation ring but "
                                         "--omega=2"):
        _run(tmp_path, 4, "--omega", "2")


def test_driver_keeps_no_reference_to_the_state_it_starts_from(
        tmp_path, monkeypatch):
    """The step replaces the server params each round: a reference the
    driver kept to the init (or to the restored state) would hold a
    second copy of them for the whole run."""
    import gc
    import weakref

    from repro_torch.checkpoint import store
    from repro_torch.core import fedopt_step as F
    refs = []

    def keep_ref(fn):
        def wrapped(*a, **kw):
            st = fn(*a, **kw)
            refs.append(weakref.ref(st["srv"]["embed_out"]))
            return st
        return wrapped
    monkeypatch.setattr(F, "init_train_state", keep_ref(F.init_train_state))
    monkeypatch.setattr(store, "restore", keep_ref(store.restore))
    for rounds in (2, 4):
        freed = []
        args = train.build_parser().parse_args(
            ARGS + ["--rounds", str(rounds), "--ckpt-dir", str(tmp_path)])
        args.on_round = lambda r, m: (gc.collect(),
                                      freed.append(refs[-1]() is None))
        train.run_pod(args)
        assert freed == [True, True]
    assert len(refs) == 3            # two inits and one restore
