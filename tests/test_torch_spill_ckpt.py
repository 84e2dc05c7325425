"""The spilled ring slots on a snapshot (``ActivationStore.arrays``,
``load_arrays``, ``like_tree``, ``slot_dtypes``, ``slot_devices``) and
``run_pod``'s checkpoints with a host pool, held against the JAX package:

* the reference's extras round trip (``tests/test_memory.py``
  ``test_checkpoint_extras_roundtrip_occupied_pool``, f32 and int8) with
  both packages' stores on the same slots: the same held keys, extra keys
  and CRC32s, and each package's store reads the other's snapshot and
  fills the same slots bit for bit (the port's int64 labels are written
  at the JAX package's int32, ROADMAP C10);
* a resumed ``run_pod`` at ``--pool-cap 2`` under a stalled server equals
  its unbroken run bit for bit (histories and every leaf), at windows 1
  and 2, with and without ``--ckpt-flush``, f32 and int8; the snapshot it
  resumes from holds the two spilled slots;
* a resume with a smaller ``--pool-cap`` than the snapshot holds is
  refused with the reference's ``ValueError``.

Tiny smollm on the CPU (G=2, batch 4, H=2, seq 16, ω=2).
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jckpt
from repro.core import control_plane as jcp
from repro.memory import ActivationStore as JStore
from repro_torch.checkpoint import store as tckpt
from repro_torch.core import control_plane as tcp
from repro_torch.core.executor import StragglerProfiles
from repro_torch.launch import train
from repro_torch.memory import ActivationStore
from repro_torch.models.common import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OMEGA = 2


# ---------------------------------------------------------------------------
# the store's extras round trip (tests/test_memory.py), across packages
# ---------------------------------------------------------------------------

def _occupied(plane_mod, store_cls, quant, label_dtype):
    """The reference's ``_occupied_plane``: a plane and its store mid-run
    with both pool slots held, from seed 7 (labels at ``label_dtype``)."""
    rng = np.random.default_rng(7)

    def payload():
        return {"acts": rng.standard_normal((3, 6)).astype(np.float32),
                "labels": rng.integers(0, 1000, (3, 4)).astype(label_dtype)}
    cp = plane_mod.ControlPlane(4, OMEGA, 2, pool_cap=2)
    st = store_cls(2, quant=quant)
    ring = [payload() for _ in range(OMEGA)]
    for _ in range(4):
        plan = cp.plan_round(reads=np.zeros(2, bool))
        for key, s in plan.fill:
            ring[s] = st.fill(key)
        for s, key in plan.spill:
            st.spill(key, ring[s])
        for h in range(2):
            if plan.send_mask[h].any():
                ring[int(plan.write_slot[h])] = payload()
        cp.finish_round()
    assert cp.pool_live == 2 and len(st) == 2
    return cp, st, ring


def _save(ckpt, d, cp, st):
    ckpt.save(str(d), 1, {"x": np.arange(3.0)},
              metadata={"control_plane": cp.state_dict(),
                        "spill_store": st.meta_dict()},
              extras={"spill": st.arrays()})
    with open(os.path.join(str(d), "step_00000001", "tree.json")) as f:
        return json.load(f)


def _port_reads(d, quant, ring):
    meta = tckpt.restore_metadata(str(d), 1)
    st = ActivationStore(2, quant=quant)
    st.load_meta(meta["spill_store"])
    slot = {k: torch.as_tensor(v) for k, v in ring[0].items()}
    like = st.like_tree(slot)
    assert all(x.device.type == "meta" for x in tree_leaves(like))
    ex = tckpt.restore_extras(str(d), 1, {"spill": like})
    st.load_arrays(ex["spill"], dtypes=st.slot_dtypes(slot),
                   devices=st.slot_devices(slot))
    return st


def _jax_reads(d, quant, ring):
    meta = jckpt.restore_metadata(str(d), 1)
    st = JStore(2, quant=quant)
    st.load_meta(meta["spill_store"])
    slot_like = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in ring[0].items()}
    ex = jckpt.restore_extras(str(d), 1, {"spill": st.like_tree(slot_like)})
    st.load_arrays(ex["spill"], dtypes=st.slot_dtypes(slot_like))
    return st


def _assert_same_fills(port, jaxs):
    assert port.keys == jaxs.keys
    for key in list(port.keys):
        a, b = port.fill(key), jaxs.fill(key)
        assert a["acts"].dtype == torch.float32
        assert a["labels"].dtype == torch.int64
        np.testing.assert_array_equal(a["acts"].numpy(), np.asarray(b["acts"]))
        np.testing.assert_array_equal(a["labels"].numpy(), b["labels"])
    assert len(port) == len(jaxs) == 0
    assert port.pool_bytes == jaxs.pool_bytes == 0


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_spill_extras_roundtrip_matches_jax(tmp_path, quant):
    tcp_, tst, tring = _occupied(tcp, ActivationStore, quant, np.int64)
    jcp_, jst, jring = _occupied(jcp, JStore, quant, np.int32)
    assert tcp_.state_dict() == json.loads(json.dumps(jcp_.state_dict()))
    tman = _save(tckpt, tmp_path / "port", tcp_, tst)
    jman = _save(jckpt, tmp_path / "jax", jcp_, jst)
    for k in ("extra_keys", "extra_checksums", "keys", "checksums"):
        assert tman[k] == jman[k], k
    assert tman["metadata"]["spill_store"] == jman["metadata"]["spill_store"]
    assert any(k.endswith("/q") for k in tman["extra_keys"]) == quant
    # each package's store reads the other's snapshot, and both fill what
    # the other's in-memory store fills
    from_jax = _port_reads(tmp_path / "jax", quant, tring)
    from_port = _jax_reads(tmp_path / "port", quant, jring)
    assert from_jax.pool_bytes - 2 * 3 * 4 * 4 == from_port.pool_bytes
    _assert_same_fills(from_jax, jst)
    _assert_same_fills(tst, from_port)


def test_arrays_are_the_stored_form_and_load_arrays_needs_meta():
    _, st, _ = _occupied(tcp, ActivationStore, True, np.int64)
    arrays = st.arrays()
    assert sorted(arrays) == [str(k) for k in st.keys]
    for payload in arrays.values():
        assert set(payload["acts"]) == {"q", "scale"}
        assert payload["acts"]["q"].dtype == torch.int8
        assert payload["acts"]["scale"].shape == ()
        assert payload["labels"].dtype == torch.int64
    with pytest.raises(KeyError, match="load_meta first"):
        ActivationStore(2).load_arrays({"0": arrays[next(iter(arrays))]})


# ---------------------------------------------------------------------------
# run_pod with a pool: a resumed run equals the unbroken one
# ---------------------------------------------------------------------------

class _Stall(StragglerProfiles):
    """The reference tests' stalled profile (``tests/test_memory.py``
    ``_StalledProfiles``): for the first ``stall`` plans every group emits
    and the server reads nothing, so slots spill; then emission stops and
    the server drains, so they fill back.  Its count of plans rides the
    snapshot in ``summary()`` and comes back through ``load_summary``, so
    a resumed run keeps the stall's phase."""

    def __init__(self, n_groups, stall=2):
        super().__init__(n_groups)
        self.stall, self.planned = stall, 0

    def produce(self, H):
        self.planned += 1           # produce() is called first each round
        return np.full((H, self.G), self.planned <= self.stall, bool)

    def reads(self, H):
        return np.full(H, self.planned > self.stall, bool)

    def summary(self):
        return {**super().summary(), "planned": self.planned}

    def load_summary(self, ps):
        super().load_summary(ps)
        self.planned = ps["planned"]


ARGS = ["--device", "cpu", "--batch", "4", "--H", "2", "--seq-len", "16",
        "--groups-per-shard", "2", "--omega", "2", "--ckpt-every", "2"]


def _run(d, rounds, *flags, pool=2):
    args = train.build_parser().parse_args(
        ARGS + ["--rounds", str(rounds), "--ckpt-dir", str(d),
                "--pool-cap", str(pool), *flags])
    args.profiles = _Stall(2)
    return train.run_pod(args)


@functools.lru_cache(maxsize=2)
def _unbroken(quant, d):
    out = _run(d, 4, *(["--spill-quant"] if quant else []))
    assert out["memory"]["spills"] == out["memory"]["fills"] == 2
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window,flush", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_resumed_pool_run_equals_the_unbroken_run(tmp_path_factory, quant,
                                                  window, flush):
    unbroken = _unbroken(quant, str(tmp_path_factory.getbasetemp()
                                    / f"unbroken-{quant}"))
    flags = (["--spill-quant"] if quant else []) + \
        ["--window", str(window)] + (["--ckpt-flush"] if flush else [])
    d = tmp_path_factory.mktemp("resumed")
    first = _run(d, 2, *flags)
    with open(d / "step_00000002" / "tree.json") as f:
        man = json.load(f)
    held = man["metadata"]["spill_store"]["entries"]
    assert len(held) == 2 and all(e["quant"] == quant for e in held.values())
    assert {k.split("/")[1] for k in man["extra_keys"]
            if k.startswith("spill/")} == set(held)
    rest = _run(d, 4, *flags)
    assert first["history"] + rest["history"] == unbroken["history"]
    la, lb = tree_leaves(rest["state"]), tree_leaves(unbroken["state"])
    assert len(la) == len(lb)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))
    assert rest["memory"]["store_fills"] == 2       # the restored slots
    assert rest["memory"]["pool_live"] == 0


def test_resume_with_a_smaller_pool_is_refused(tmp_path):
    _run(tmp_path, 2)
    with pytest.raises(ValueError, match="snapshot holds 2 spilled slots "
                                         "but this ControlPlane has "
                                         "pool_cap=1"):
        _run(tmp_path, 4, pool=1)
