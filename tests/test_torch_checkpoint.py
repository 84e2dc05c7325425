"""The port's checkpoint store (``repro_torch/checkpoint/store.py``), its
restart policy (``runtime/fault_tolerance.py``) and the plan checkpointing
of its control plane and stores, mirroring the JAX package's tests
(``tests/test_runtime.py``, the torn-snapshot half of
``tests/test_faults.py``, ``tests/test_control_plane.py``'s and
``tests/test_memory.py``'s ``state_dict`` tests and
``tests/test_executor.py``'s retention riding), and held against the JAX
package exactly:

* one state carried across with ``convert.state_from_numpy`` gives the
  same manifest ``keys``, CRC32 ``checksums``, ``extra_keys`` and
  ``extra_checksums`` in both stores;
* each package's ``restore`` reads the other's snapshot bit for bit;
* ``ControlPlane.state_dict`` is JSON-equal after the same plans;
* both executors, on a stub step under churn, save the same rounds with
  the same control-plane and retention metadata.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint import store as jstore
from repro.configs import registry as jreg
from repro.core import control_plane as jcp
from repro.core import executor as jex
from repro.core import fedopt_step as JF
from repro_torch.checkpoint import store
from repro_torch.convert import state_from_numpy
from repro_torch.core import control_plane as tcp
from repro_torch.core import executor as tex
from repro_torch.faults import TEAR_MODES, tear_snapshot
from repro_torch.memory import ActivationStore
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime.fault_tolerance import (CheckpointPolicy,
                                                 resume_or_init)

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# checkpoint store (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(int(v), dtype=torch.int64)}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    store.save(d, 10, _state(3.0), metadata={"lr": 0.1})
    out = store.restore(d, 10, _state())
    assert torch.equal(out["params"]["w"], torch.full((4, 4), 3.0))
    assert out["step"].dtype == torch.int64 and int(out["step"]) == 3
    assert store.restore_metadata(d, 10)["lr"] == 0.1


def test_latest_and_retention(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        store.save(d, s, _state(float(s)), retain=3)
    assert store.latest_step(d) == 5
    assert store.committed_steps(d) == [3, 4, 5]   # older GC'd


def test_uncommitted_snapshot_ignored(tmp_path):
    d = str(tmp_path)
    store.save(d, 1, _state(1.0))
    # a crash mid-write: a directory without the COMMITTED marker
    os.makedirs(os.path.join(d, "step_00000002"))
    assert store.latest_step(d) == 1
    with pytest.raises(FileNotFoundError):
        store.restore(d, 2, _state())


def test_restore_into_meta_template_onto_a_device(tmp_path):
    """The ``jax.eval_shape`` template's counterpart: tensors on ``meta``
    come back on ``device`` (default the CPU) with the template's
    dtypes."""
    d = str(tmp_path)
    store.save(d, 7, _state(2.0))
    like = tree_map(lambda x: x.to("meta"), _state())
    for device in (None, "cpu"):
        out = store.restore(d, 7, like, device=device)
        assert torch.equal(out["params"]["w"], torch.full((4, 4), 2.0))
        assert all(x.device.type == "cpu" for x in tree_leaves(out))
        assert out["step"].dtype == torch.int64


def test_int64_leaves_are_written_at_int32_and_widened_back(tmp_path):
    """C10, decided: the port's int64 leaves are the JAX package's int32
    bytes in the snapshot; restore gives the template's dtype back."""
    d = str(tmp_path)
    labels = torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4)
    store.save(d, 1, {"labels": labels})
    with np.load(os.path.join(d, "step_00000001", "arrays.npz")) as z:
        assert z["labels"].dtype == np.int32
        np.testing.assert_array_equal(z["labels"], labels.numpy())
    out = store.restore(d, 1, {"labels": torch.empty(0, dtype=torch.int64)})
    assert out["labels"].dtype == torch.int64
    assert torch.equal(out["labels"], labels)
    with pytest.raises(OverflowError, match="labels"):
        store.save(d, 2, {"labels": torch.tensor([2 ** 40])})


def test_bfloat16_leaf_is_refused_by_name(tmp_path):
    with pytest.raises(TypeError, match="'srv/w'.*bfloat16"):
        store.save(str(tmp_path), 1,
                   {"srv": {"w": torch.zeros(2, dtype=torch.bfloat16)}})
    assert store.committed_steps(str(tmp_path)) == []


def test_keys_follow_the_jax_flatten_order(tmp_path):
    """Dicts in sorted-key order, lists by index, None no leaf — the keys
    ``jax.tree_util.tree_flatten_with_path`` gives; the restored tree
    keeps the template's own key order."""
    tree = {"z": torch.ones(1), "a": [torch.zeros(2), None,
                                      {"y": torch.ones(3), "b": torch.ones(1)}]}
    d = str(tmp_path)
    store.save(d, 1, tree)
    with open(os.path.join(d, "step_00000001", "tree.json")) as f:
        keys = json.load(f)["keys"]
    jtree = jax.tree.map(lambda x: x.numpy(), tree)
    want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert keys == want == ["a/0", "a/2/b", "a/2/y", "z"]
    out = store.restore(d, 1, tree)
    assert list(out) == ["z", "a"] and out["a"][1] is None
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(out), tree_leaves(tree))
               if y is not None)


# ---------------------------------------------------------------------------
# torn snapshots: verified fallback, never half-loads (tests/test_faults.py)
# ---------------------------------------------------------------------------

def _tree(v):
    return {"w": np.full((4, 3), float(v)), "step": np.asarray(v, np.int64)}


@pytest.mark.parametrize("mode", TEAR_MODES)
def test_restore_torn_snapshot_raises_not_half_loads(tmp_path, mode):
    d = str(tmp_path)
    store.save(d, 1, _tree(1))
    tear_snapshot(d, 1, mode)
    ok, reason = store.verify_snapshot(d, 1)
    assert not ok and reason
    with pytest.raises(store.CorruptSnapshotError):
        store.restore(d, 1, _tree(0))


@pytest.mark.parametrize("mode", TEAR_MODES)
def test_resume_falls_back_to_previous_verified_snapshot(tmp_path, mode):
    d = str(tmp_path)
    for s in (1, 2, 3):
        store.save(d, s, _tree(s))
    tear_snapshot(d, 3, mode)
    step, skipped = store.latest_verified_step(d)
    assert step == 2
    assert [s for s, _ in skipped] == [3]
    policy = CheckpointPolicy(d, every_steps=10)
    state, start = resume_or_init(d, lambda: _tree(0), policy=policy)
    assert start == 2
    np.testing.assert_array_equal(state["w"], _tree(2)["w"])
    assert policy._last_step == 2           # cadence seeded from the resume
    assert not policy.should_save(2)
    assert policy.should_save(12)


def test_resume_all_torn_initializes_fresh(tmp_path):
    d = str(tmp_path)
    store.save(d, 1, _tree(1), retain=1)
    tear_snapshot(d, 1, "truncate")
    state, start = resume_or_init(d, lambda: _tree(0))
    assert start == 0
    np.testing.assert_array_equal(state["w"], _tree(0)["w"])


# ---------------------------------------------------------------------------
# control-plane checkpointing (tests/test_control_plane.py)
# ---------------------------------------------------------------------------

PRODUCE = np.array([[True, True, False], [True, False, True],
                    [True, True, True], [False, True, False]])
READS = np.array([True, False, True, False])


def _assert_plans_equal(p1, p2):
    np.testing.assert_array_equal(p1.read_slot, p2.read_slot)
    np.testing.assert_array_equal(p1.write_slot, p2.write_slot)
    np.testing.assert_array_equal(p1.send_mask, p2.send_mask)
    np.testing.assert_array_equal(p1.agg_weight, p2.agg_weight)


@pytest.mark.parametrize("policy", ["counter", "fifo"])
def test_state_dict_roundtrip_preserves_plan(policy):
    """A restored ControlPlane plans identically to the original (slot
    occupancy, queue order, flow tokens, counters and staleness)."""
    cp = tcp.ControlPlane(3, 2, 4, policy=policy)
    for _ in range(3):
        cp.plan_round(produce=PRODUCE, reads=READS)
        cp.finish_round(active=np.array([True, False, True]))
    sd = cp.state_dict()
    json.dumps(sd)                             # checkpoint-metadata safe
    cp2 = tcp.ControlPlane(3, 2, 4, policy=policy)
    cp2.load_state_dict(sd)
    assert cp2.within_cap
    for _ in range(3):                         # stays in lockstep
        _assert_plans_equal(cp.plan_round(produce=PRODUCE, reads=READS),
                            cp2.plan_round(produce=PRODUCE, reads=READS))
        assert cp.consumption == cp2.consumption


def test_state_dict_roundtrip_partial_ring_with_dropped_groups():
    """An ω>1 ring only partly occupied, with a dropped group: occupancy,
    the roster (prev_active) and the retention store (metadata + arrays)
    survive, and the restored plane plans the rejoin identically."""
    G, omega, H = 3, 2, 4
    produce = np.zeros((H, G), bool)
    produce[:, 0] = True
    produce[::4, 1] = True
    reads = np.arange(H) % 2 == 0
    active = np.array([True, True, False])      # group 2 dropped

    cp = tcp.ControlPlane(G, omega, H)
    plans = [cp.plan_round(active=active, produce=produce, reads=reads)]
    assert plans[0].retire == (2,)
    cp.retain_group(2, {"dev": {"w": torch.arange(4.0)},
                        "aux": {"b": torch.full((2,), 7.0)}})
    cp.finish_round(active=active)
    for _ in range(2):
        plans.append(cp.plan_round(active=active, produce=produce,
                                   reads=reads))
        cp.finish_round(active=active)
    assert 0 < cp.live_slots <= omega           # partially occupied ring

    sd = cp.state_dict()
    json.dumps(sd)
    cp2 = tcp.ControlPlane(G, omega, H)
    cp2.load_state_dict(sd)
    cp2.retention.load_arrays(cp.retention.arrays())
    assert cp2.within_cap
    assert cp2.live_slots == cp.live_slots
    np.testing.assert_array_equal(cp2.prev_active, cp.prev_active)
    assert cp2.retention.groups == [2]
    assert cp2.retention.version_of(2) == cp.retention.version_of(2)
    for k, leaf in (("dev", "w"), ("aux", "b")):
        assert torch.equal(cp2.retention.params_of(2)[k][leaf],
                           cp.retention.params_of(2)[k][leaf])
    for roster in (np.array([True, True, False]), np.ones(G, bool),
                   np.ones(G, bool)):
        p1 = cp.plan_round(active=roster, produce=produce, reads=reads)
        p2 = cp2.plan_round(active=roster, produce=produce, reads=reads)
        _assert_plans_equal(p1, p2)
        np.testing.assert_array_equal(p1.bcast_mask, p2.bcast_mask)
        assert p1.retire == p2.retire and p1.restore == p2.restore
        cp.finish_round(active=roster)
        cp2.finish_round(active=roster)
    assert p1.restore == ()                    # no transition in final round
    assert cp.consumption == cp2.consumption


def test_load_state_dict_rejects_policy_mismatch():
    cp = tcp.ControlPlane(2, 2, 4, policy="counter")
    cp.plan_round()
    sd = cp.state_dict()
    with pytest.raises(ValueError, match="policy"):
        tcp.ControlPlane(2, 2, 4, policy="fifo").load_state_dict(sd)


# ---------------------------------------------------------------------------
# v3 and v2 snapshots of the plane (tests/test_memory.py, the plane half)
# ---------------------------------------------------------------------------

OMEGA = 2


def _occupied_plane(pool=2, module=tcp):
    """A plane mid-run with a genuinely occupied spill pool (the port's
    store beside the port's plane)."""
    cp = module.ControlPlane(4, OMEGA, 2, pool_cap=pool)
    astore = ActivationStore(pool) if module is tcp else None
    ring = [{"acts": torch.full((3, 6), float(s))} for s in range(OMEGA)]
    for r in range(2 + pool):
        plan = cp.plan_round(reads=np.zeros(2, bool))
        if astore is not None:
            for key, s in plan.fill:
                ring[s] = astore.fill(key)
            for s, key in plan.spill:
                astore.spill(key, ring[s])
            for h in range(2):
                if plan.send_mask[h].any():
                    ring[int(plan.write_slot[h])] = {
                        "acts": torch.full((3, 6), 10.0 * r + h)}
        cp.finish_round()
    assert cp.pool_live == pool
    assert astore is None or len(astore) == pool
    return cp, astore


def test_state_dict_v3_roundtrip_with_occupied_pool():
    cp, _ = _occupied_plane()
    sd = cp.state_dict()
    json.dumps(sd)
    assert sd["version_tag"] == 3 and len(sd["pool"]) == 2
    cp2 = tcp.ControlPlane(4, OMEGA, 2, pool_cap=2)
    cp2.load_state_dict(sd)
    assert cp2.within_cap and cp2.pool_occupancy == cp.pool_occupancy
    assert cp2.flow.buffered == cp.flow.buffered   # pooled units counted
    quiet = np.zeros((2, 4), bool)
    for r in range(6):                  # lockstep through the drain
        p1 = cp.plan_round(produce=quiet, reads=np.ones(2, bool))
        p2 = cp2.plan_round(produce=quiet, reads=np.ones(2, bool))
        np.testing.assert_array_equal(p1.read_slot, p2.read_slot)
        np.testing.assert_array_equal(p1.send_mask, p2.send_mask)
        assert p1.fill == p2.fill and p1.spill == p2.spill
        cp.finish_round()
        cp2.finish_round()
    assert cp.n_fills == cp2.n_fills > 0


def test_load_rejects_undersized_pool_and_policy_mismatch():
    cp, astore = _occupied_plane()
    sd = cp.state_dict()
    with pytest.raises(ValueError, match="pool_cap"):
        tcp.ControlPlane(4, OMEGA, 2, pool_cap=1).load_state_dict(sd)
    with pytest.raises(ValueError, match="eviction"):
        tcp.ControlPlane(4, OMEGA, 2, pool_cap=2,
                         eviction="lru").load_state_dict(sd)
    with pytest.raises(ValueError, match="pool_cap"):
        ActivationStore(1).load_meta(astore.meta_dict())


def test_v2_snapshot_without_spill_metadata_still_loads():
    """Snapshots from before the tiered store (no pool/eviction keys)
    restore into a pool-capable plane: empty tier, same plans."""
    cp = tcp.ControlPlane(3, OMEGA, 2)
    for _ in range(3):
        cp.plan_round(reads=np.array([True, False]))
        cp.finish_round()
    sd = cp.state_dict()
    for k in ("version_tag", "pool_cap", "eviction", "pool",
              "next_pool_key", "slot_touch", "tick", "n_spills",
              "n_fills", "peak_pool"):
        sd.pop(k)                                  # what a v2 writer wrote
    cp2 = tcp.ControlPlane(3, OMEGA, 2, pool_cap=4)
    cp2.load_state_dict(sd)
    assert cp2.within_cap and cp2.pool_live == 0
    p1, p2 = cp.plan_round(), cp2.plan_round()
    np.testing.assert_array_equal(p1.read_slot, p2.read_slot)
    np.testing.assert_array_equal(p1.send_mask, p2.send_mask)


def test_store_meta_matches_jax_for_an_empty_and_an_occupied_pool():
    """``spill_store`` in a snapshot's metadata is the reference's: an
    empty store's exactly (the pool-0 path), and an occupied one's held
    keys and flags, which ``load_meta`` restores."""
    from repro.memory import ActivationStore as JStore
    for cap, quant in ((0, False), (2, True)):
        assert ActivationStore(cap, quant=quant).meta_dict() == \
            JStore(cap, quant=quant).meta_dict()
    _, astore = _occupied_plane()
    meta = astore.meta_dict()
    other = ActivationStore(2)
    other.load_meta(json.loads(json.dumps(meta)))
    assert other.keys == astore.keys and other.meta_dict() == meta


# ---------------------------------------------------------------------------
# retention rides the checkpoint (tests/test_executor.py)
# ---------------------------------------------------------------------------

def test_retention_rides_checkpoint_extras(tmp_path):
    cp = tcp.ControlPlane(3, 2, 4)
    cp.plan_round(active=np.array([True, True, False]))     # drops group 2
    params = {"dev": {"w": torch.arange(6.0).reshape(2, 3)},
              "aux": {"b": torch.ones(4)}}
    cp.retain_group(2, params)
    cp.finish_round(active=np.array([True, True, False]))

    sd = cp.state_dict()
    json.dumps(sd)
    store.save(str(tmp_path), 5, {"x": torch.zeros(2)},
               metadata={"control_plane": sd},
               extras=cp.retention.arrays())

    meta = store.restore_metadata(str(tmp_path), 5)
    cp2 = tcp.ControlPlane(3, 2, 4)
    cp2.load_state_dict(meta["control_plane"])
    assert cp2.retention.groups == [2]
    assert cp2.retention.version_of(2) == cp.retention.version_of(2)
    assert cp2.retention.params_of(2) is None      # arrays not yet loaded
    like = tree_map(lambda x: x.to("meta"), cp.retention.arrays())
    cp2.retention.load_arrays(store.restore_extras(str(tmp_path), 5, like))
    for la, lb in zip(tree_leaves(cp.retention.params_of(2)),
                      tree_leaves(cp2.retention.params_of(2))):
        assert torch.equal(la, lb)
    p1 = cp.plan_round(active=np.ones(3, bool))
    p2 = cp2.plan_round(active=np.ones(3, bool))
    assert p1.restore == p2.restore == (2,)
    np.testing.assert_array_equal(p1.agg_weight, p2.agg_weight)


def test_rejoin_without_restored_arrays_raises():
    cp = tcp.ControlPlane(2, 1, 2)
    cp.plan_round(active=np.array([True, False]))
    cp.retain_group(1, {"dev": torch.zeros(2), "aux": torch.zeros(2)})
    cp2 = tcp.ControlPlane(2, 1, 2)
    cp2.load_state_dict(cp.state_dict())        # metadata only, no arrays
    ex = tex.RoundExecutor(lambda s, b: (s, {"d_loss": 0.0}), cp2, window=1,
                           gather=lambda s, g: None,
                           scatter=lambda s, g, p: s)
    with pytest.raises(RuntimeError, match="extras"):
        ex.run(0, 0, 1, active_fn=lambda r: np.ones(2, bool),
               batch_fn=lambda r, plan: {})
    # the error path must not destroy the retained entry
    assert 1 in cp2.retention


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_round():
    """The JAX state after one round of smoke smollm at ω=2 in which group
    1 dropped, so the plane retains it; as numpy, with the plane."""
    G, H, B, S = 2, 2, 2, 16
    jcfg = JF.FedStepConfig(arch=jreg.smoke_config("smollm-135m"),
                            l_split=1, n_groups=G, seq_len=S,
                            per_group_batch=B * H, H=H, omega=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jitted, _, s_spec, _ = JF.jit_train_step(jcfg, mesh, donate=False)
    jstate = jax.jit(lambda: JF.init_train_state(jax.random.PRNGKey(0),
                                                 jcfg),
                     out_shardings=s_spec)()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.arch.vocab, (G, H, B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.arch.vocab, (G, H, B, S)).astype(np.int32)
    plane = jcp.ControlPlane(G, jcfg.omega, jcfg.H)
    ex = jex.RoundExecutor(
        jitted, plane, window=1, profiles=jex.StragglerProfiles(G),
        gather=JF.gather_group_state,
        scatter=lambda st, g, p: JF.scatter_group_state(st, g, p, s_spec))
    jstate, _ = ex.run(jstate, 0, 1,
                       active_fn=lambda r: np.array([True, False]),
                       batch_fn=lambda r, plan: {"tokens": tokens,
                                                 "labels": labels,
                                                 **plan.batch_fields()})
    assert plane.retention.groups == [1]
    numpy_state = jax.tree.map(np.asarray, jstate)
    retained = jax.tree.map(np.asarray, plane.retention.arrays())
    return numpy_state, retained, plane


def _manifest(d, step=1):
    with open(os.path.join(d, f"step_{step:08d}", "tree.json")) as f:
        return json.load(f)


def _save_both(tmp_path, jax_round):
    numpy_state, retained, plane = jax_round
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    meta = {"control_plane": plane.state_dict()}
    jstore.save(jd, 1, numpy_state, metadata=meta,
                extras={"retention": retained})
    store.save(td, 1, state_from_numpy(numpy_state, "cpu"), metadata=meta,
               extras={"retention": state_from_numpy(retained, "cpu")})
    return jd, td


def test_manifest_matches_jax_for_one_state(tmp_path, jax_round):
    jd, td = _save_both(tmp_path, jax_round)
    jm, tm = _manifest(jd), _manifest(td)
    for k in ("keys", "checksums", "extra_keys", "extra_checksums",
              "metadata", "step"):
        assert tm[k] == jm[k], k
    assert any(k.startswith("act_buf/labels") for k in tm["keys"])
    assert tm["extra_keys"][0].startswith("retention/1/")


def test_each_store_reads_the_others_snapshot_bit_for_bit(tmp_path,
                                                          jax_round):
    numpy_state, retained, _ = jax_round
    jd, td = _save_both(tmp_path, jax_round)
    want = state_from_numpy(numpy_state, "cpu")
    for like in (want, tree_map(lambda x: x.to("meta"), want)):
        got = store.restore(jd, 1, like)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    tret = state_from_numpy(retained, "cpu")
    got = store.restore_extras(jd, 1, {"retention": tret})["retention"]
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(tret)))
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         numpy_state)
    back = jstore.restore(td, 1, jlike)
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(a, b),
                               _same_dtype(a, b)), back, numpy_state)
    jback = jstore.restore_extras(td, 1, {"retention": retained})
    jax.tree.map(np.testing.assert_array_equal, jback["retention"],
                 retained)


def _same_dtype(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype


def _plan_both(build, drive):
    """The port's and the JAX package's planes, built and driven alike;
    their ``state_dict`` as JSON."""
    out = []
    for module in (tcp, jcp):
        cp = build(module)
        drive(cp)
        out.append(json.dumps(cp.state_dict(), sort_keys=True))
    return out


@pytest.mark.parametrize("policy", ["counter", "fifo"])
def test_state_dict_is_json_equal_to_jax(policy):
    def drive(cp):
        for r in range(4):
            active = np.array([True, r % 2 == 0, True])
            cp.plan_round(active=active, produce=PRODUCE, reads=READS)
            cp.finish_round(active=active)
    t, j = _plan_both(lambda m: m.ControlPlane(3, 2, 4, policy=policy),
                      drive)
    assert t == j


@pytest.mark.parametrize("eviction", ["share", "lru"])
def test_state_dict_with_an_occupied_pool_is_json_equal_to_jax(eviction):
    def drive(cp):
        for _ in range(4):
            cp.plan_round(reads=np.zeros(2, bool))
            cp.finish_round()
    t, j = _plan_both(lambda m: m.ControlPlane(4, OMEGA, 2, pool_cap=2,
                                               eviction=eviction), drive)
    assert t == j and len(json.loads(t)["pool"]) == 2


# ---------------------------------------------------------------------------
# the executors' saves in lockstep, on a stub step
# ---------------------------------------------------------------------------

LOCK_G, LOCK_ROUNDS = 3, 8
LOCK_ROSTERS = [np.random.default_rng([5, r]).random(LOCK_G) >= 0.3
                for r in range(LOCK_ROUNDS)]


def _lockstep_run(torch_side: bool, window: int, flush: bool):
    """A stub step that adds 1 to every dev/aux leaf, under
    ``LOCK_ROSTERS``; every second round saved.  Returns {round: (the
    control plane, the retention metadata and arrays, the state)}."""
    G = LOCK_G
    if torch_side:
        cp = tcp.ControlPlane(G, 2, 2)
        state = {"dev": {"w": torch.zeros(G, 3)},
                 "aux": {"b": torch.zeros(G, 2)}}

        def step(s, b):
            for k in ("dev", "aux"):
                tree_map(lambda x: x.add_(1.0), s[k])
            return s, {"d_loss": 0.0, "s_loss": 0.0}
        gather = lambda s, g: {k: tree_map(lambda x: x[g].clone(), s[k])
                               for k in ("dev", "aux")}

        def scatter(s, g, p):
            for k in ("dev", "aux"):
                tree_map(lambda x, v: x[g].copy_(v), s[k], p[k])
            return s
        host = lambda t: tree_map(lambda x: x.numpy().copy(), t)
        ex = tex.RoundExecutor(step, cp, window=window,
                               profiles=tex.StragglerProfiles(G),
                               gather=gather, scatter=scatter)
    else:
        cp = jcp.ControlPlane(G, 2, 2)
        state = {"dev": {"w": np.zeros((G, 3), np.float32)},
                 "aux": {"b": np.zeros((G, 2), np.float32)}}
        step = lambda s, b: ({k: {n: x + 1.0 for n, x in s[k].items()}
                              for k in s}, {"d_loss": 0.0, "s_loss": 0.0})
        gather = lambda s, g: {k: {n: np.array(x[g]) for n, x in s[k].items()}
                               for k in ("dev", "aux")}

        def scatter(s, g, p):
            out = {k: {n: x.copy() for n, x in s[k].items()} for k in s}
            for k in ("dev", "aux"):
                for n in out[k]:
                    out[k][n][g] = p[k][n]
            return out
        host = lambda t: jax.tree.map(np.asarray, t)
        ex = jex.RoundExecutor(step, cp, window=window,
                               profiles=jex.StragglerProfiles(G),
                               gather=gather, scatter=scatter)
    saves = {}

    def capture_fn(r):
        return {"control_plane": cp.state_dict(),
                "retention": cp.retention.meta_dict(),
                "arrays": host(cp.retention.arrays())}

    def checkpoint_fn(r, handle):
        saves[r] = (handle.meta, host(handle.host_tree()))
    ex.run(state, 0, LOCK_ROUNDS, active_fn=lambda r: LOCK_ROSTERS[r],
           batch_fn=lambda r, plan: {}, checkpoint_every=2,
           checkpoint_fn=checkpoint_fn, capture_fn=capture_fn,
           checkpoint_flush=flush)
    return saves


@pytest.mark.parametrize("window,flush", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_executor_saves_match_jax_in_lockstep(window, flush):
    t = _lockstep_run(True, window, flush)
    j = _lockstep_run(False, window, flush)
    assert sorted(t) == sorted(j) == [1, 3, 5, 7]
    held = 0
    for r in t:
        (tm, ts), (jm, js) = t[r], j[r]
        assert tm["control_plane"] == jm["control_plane"], r
        assert tm["retention"] == jm["retention"], r
        assert tm["arrays"].keys() == jm["arrays"].keys(), r
        for g in tm["arrays"]:
            jax.tree.map(np.testing.assert_array_equal, tm["arrays"][g],
                         jm["arrays"][g])
        jax.tree.map(np.testing.assert_array_equal, ts, js)
        held += len(tm["arrays"])
    assert held > 0                   # some save carried a retained group
