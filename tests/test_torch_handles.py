"""The port's round handles (``repro_torch/core/handles.py``), mirroring
``tests/test_handles.py``: a snapshot survives the in-place update of its
source (the torch form of donation), numpy leaves are copied and scalars
passed through, the staged host copy is bit-exact, subsets and slices
match the live state, the host tree is cached, ``copy=False`` wraps the
live tree, and the ring evicts the oldest handle and tracks its peak
bytes.  On the CPU every copy is synchronous; the card's streams and
events are tested in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.handles import HandleRing, RoundHandle, snapshot_tree
from repro_torch.models.common import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"dev": {"w": t(2, 3)},
            "aux": {"b": torch.arange(4, dtype=torch.float32)},
            "act_buf": {"acts": t(2, 5)},
            "host": np.arange(6.0),
            "step": 7}


def test_snapshot_survives_in_place_update_of_the_source():
    """The port's step updates its state in place: a snapshot taken before
    the update must keep the old values."""
    src = torch.arange(8, dtype=torch.float32)
    snap = snapshot_tree({"x": src})
    src.add_(1.0)                       # the next round's in-place update
    torch.testing.assert_close(snap["x"], torch.arange(8, dtype=torch.float32),
                               rtol=0, atol=0)
    assert snap["x"].data_ptr() != src.data_ptr()


def test_snapshot_copies_numpy_leaves_and_passes_scalars():
    host = np.arange(3.0)
    snap = snapshot_tree({"h": host, "s": 5})
    host[0] = 99.0                      # mutate AFTER the snapshot
    np.testing.assert_array_equal(snap["h"], [0.0, 1.0, 2.0])
    assert snap["s"] == 5


def test_to_host_keeps_values_bitexact():
    t = _tree()
    a = snapshot_tree(t)
    h = RoundHandle.capture(0, t, to_host=True)
    for la, lb in zip(tree_leaves(a), tree_leaves(h.host_tree())):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_capture_keys_subset_and_has():
    h = RoundHandle.capture(3, _tree(), keys=("dev", "aux"))
    assert h.round == 3
    assert h.has("dev") and h.has("aux")
    assert not h.has("act_buf") and not h.has("host")


def test_group_state_matches_live_slices():
    t = _tree(seed=4)
    h = RoundHandle.capture(0, t, keys=("dev", "aux"))
    g = 1
    got = h.group_state(g)
    torch.testing.assert_close(got["dev"]["w"], t["dev"]["w"][g], rtol=0,
                               atol=0)
    torch.testing.assert_close(got["aux"]["b"], t["aux"]["b"][g], rtol=0,
                               atol=0)
    got["dev"]["w"].add_(1.0)           # the payload is its own copy
    torch.testing.assert_close(h.tree["dev"]["w"][g], t["dev"]["w"][g],
                               rtol=0, atol=0)


def test_ready_and_host_tree_cached():
    h = RoundHandle.capture(0, _tree(), to_host=True, meta={"r": 0})
    assert h.ready()
    ht = h.host_tree()
    assert h.host_tree() is ht          # cached
    assert isinstance(ht["dev"]["w"], torch.Tensor)
    assert ht["dev"]["w"].device.type == "cpu"
    assert h.meta == {"r": 0}
    assert h.nbytes == (6 + 4 + 10) * 4 + 6 * 8


def test_capture_copy_false_wraps_live_tree():
    t = _tree()
    h = RoundHandle.capture(2, t, copy=False)
    assert h.tree is t                  # the flush path: no copies


def test_ring_evicts_oldest_and_tracks_peak_bytes():
    ring = HandleRing(depth=2)
    for r in range(4):
        ring.push(RoundHandle.capture(r, {"x": torch.zeros(8)}))
    assert len(ring) == 2
    assert ring.get(0) is None and ring.get(1) is None
    assert ring.get(2).round == 2 and ring.get(3).round == 3
    s = ring.summary()
    assert s["held"] == 2 and s["captured"] == 4
    assert s["peak_bytes"] == s["bytes"] == 2 * 32
    assert ring.nbytes == 64


def test_ring_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        HandleRing(depth=0)
