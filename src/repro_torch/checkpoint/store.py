"""Fault-tolerant checkpoint store: atomic, versioned, verified snapshots.

Layout::

    <dir>/step_000120/arrays.npz     # flattened leaves
    <dir>/step_000120/extras.npz     # optional side payload (same format)
    <dir>/step_000120/tree.json      # treedef + keys + checksums + metadata
    <dir>/step_000120/COMMITTED      # written last — presence = valid

Crash consistency is layered:

* **atomic commit** — writes go to a temp dir, every file (and the temp
  dir itself) is fsynced, then the dir is renamed into place and the
  parent fsynced; a crash mid-write never corrupts the store, and a
  committed rename implies the payload bytes are durable (the save runs
  while later rounds are still in flight, so the window between "save
  returned" and "data on disk" overlaps live training).  ``latest_step``
  ignores uncommitted snapshots (a missing COMMITTED marker = the rename
  never happened).
* **per-array checksums** — the manifest records a CRC32 per leaf
  (``checksums`` / ``extra_checksums``), so a snapshot torn AFTER commit
  (bit rot, truncation, a partial copy) is detected at restore instead of
  silently half-loading; every restore path raises
  :class:`CorruptSnapshotError` rather than returning damaged arrays.
* **verified fallback** — :func:`verify_snapshot` checks one snapshot end
  to end and :func:`latest_verified_step` walks committed snapshots newest
  first, returning the newest one that verifies plus the list it skipped
  (``runtime.fault_tolerance.resume_or_init`` resumes from that and
  reports the skips).  Pre-checksum snapshots verify by loadability only.

``extras`` is a second, independently-structured tree riding the same
atomic snapshot — used for state whose structure varies run to run (the
control plane's per-group retention store: which groups are held changes
with churn; the JSON ``metadata`` describes the structure, ``extras.npz``
carries the arrays).

The torch form of the JAX package's ``checkpoint/store.py``, and its
snapshots are that store's: the same files, the same leaf keys (dicts in
sorted-key order, lists and tuples by index, joined with ``"/"``; ``None``
is no leaf), the same bytes and CRC32s.  Trees are nested dicts, lists and
tuples of tensors (on any device) or numpy arrays.  An int64 tensor — the
port's index type, where the JAX package holds int32 — is written at
int32 (its values must fit), and :func:`restore` widens it back to the
template's dtype.  A bfloat16 leaf is refused by name: numpy has no
bfloat16 of its own.  ``tree.json``'s ``treedef`` describes the port's
tree; both stores address leaves by key and neither reads it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch


class CorruptSnapshotError(RuntimeError):
    """A committed snapshot failed verification (torn file, checksum
    mismatch, unreadable manifest, missing/mismatched leaves)."""


def _leaves_with_paths(tree, path=(), *, sort: bool = True):
    """(key path, leaf) pairs; ``None`` is no leaf.  ``sort`` takes dicts
    in sorted-key order, the JAX package's flatten order (the snapshot's
    key order); else in the tree's own order, as :func:`_rebuild` walks
    it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in (sorted(tree) if sort else tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(path, tree)]
    return [pair for k, child in items
            for pair in _leaves_with_paths(child, path + (k,), sort=sort)]


def _treedef(tree) -> str:
    """The tree's structure, ``*`` for a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(key: str, leaf) -> np.ndarray:
    """A leaf as the numpy array the snapshot holds."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if leaf.dtype == torch.bfloat16:
        raise TypeError(f"leaf {key!r} is bfloat16: the checkpoint store "
                        "writes numpy arrays, and numpy has no bfloat16")
    x = leaf.detach().cpu().numpy()
    if x.dtype == np.int64:
        info = np.iinfo(np.int32)
        if x.size and (x.min() < info.min or x.max() > info.max):
            raise OverflowError(f"int64 leaf {key!r} holds values outside "
                                "int32, the width the snapshot keeps")
        x = x.astype(np.int32)
    return x


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host(_key(path), leaf)
            for path, leaf in _leaves_with_paths(tree)}


def _crc(arr: np.ndarray) -> int:
    # the CRC32 of the array's C-order bytes, read in place (no copy)
    return zlib.crc32(np.ascontiguousarray(arr))


def _checksums(flat: dict[str, np.ndarray]) -> dict[str, int]:
    """Every leaf's CRC32, the leaves spread over threads (``zlib.crc32``
    releases the GIL on large buffers)."""
    keys = list(flat)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(keys, pool.map(lambda k: _crc(flat[k]), keys)))


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return          # platforms without O_RDONLY dirs: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(directory: str, step: int, tree: Any, metadata: dict | None = None,
         retain: int = 3, extras: Any = None) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_{name}_")
    try:
        flat = _flatten_with_paths(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "treedef": _treedef(tree),
                "keys": list(flat.keys()),
                "checksums": _checksums(flat),
                "metadata": metadata or {}}
        if extras is not None and _leaves_with_paths(extras):
            eflat = _flatten_with_paths(extras)
            np.savez(os.path.join(tmp, "extras.npz"), **eflat)
            meta["extra_keys"] = list(eflat.keys())
            meta["extra_checksums"] = _checksums(eflat)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        # durability before visibility: every payload byte must be on disk
        # before the rename makes the snapshot discoverable — otherwise a
        # power cut after commit leaves a COMMITTED marker over torn data
        for fname in os.listdir(tmp):
            _fsync_file(os.path.join(tmp, fname))
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(directory)     # persist the rename itself
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, retain)
    return final


def _gc(directory: str, retain: int):
    steps = committed_steps(directory)
    for s in steps[:-retain] if retain else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, "COMMITTED")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _load_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:08d}", "tree.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as err:
        raise CorruptSnapshotError(
            f"unreadable snapshot manifest {path}: {err}") from err


def _load_npz(npz_path: str) -> dict[str, np.ndarray]:
    try:
        with np.load(npz_path) as z:
            return {k: z[k] for k in z.files}
    except Exception as err:     # zipfile/npy corruption surfaces variedly
        raise CorruptSnapshotError(
            f"unreadable snapshot payload {npz_path}: {err}") from err


def _verify_flat(flat: dict, keys: list, checksums: dict | None,
                 npz_path: str) -> None:
    missing = [k for k in keys if k not in flat]
    if missing:
        raise CorruptSnapshotError(
            f"{npz_path} is missing {len(missing)} manifest leaves "
            f"(first: {missing[0]!r})")
    if checksums:
        got = _checksums({k: flat[k] for k in keys if k in checksums})
        for k in keys:
            want = checksums.get(k)
            if want is not None and got[k] != want:
                raise CorruptSnapshotError(
                    f"checksum mismatch for leaf {k!r} in {npz_path} — "
                    "the snapshot was torn after commit; restore from an "
                    "older verified snapshot instead")


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken in order from
    ``values`` (an iterator)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values) for x in tree)
    return next(values)


def _like_leaf(key: str, arr: np.ndarray, like, device):
    """The stored array as ``like``'s kind and dtype: a tensor on
    ``device`` (default ``like``'s, the CPU for a ``meta`` template) or a
    numpy array.  Only a lossless cast is taken (int32 back to int64)."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            raise TypeError(f"leaf {key!r} is bfloat16: the checkpoint "
                            "store holds numpy arrays, and numpy has no "
                            "bfloat16")
        want = torch.empty((), dtype=like.dtype).numpy().dtype
        dev = device if device is not None else \
            (torch.device("cpu") if like.device.type == "meta"
             else like.device)
    else:
        want, dev = getattr(like, "dtype", arr.dtype), None
    if arr.dtype != want and not np.can_cast(arr.dtype, want, "safe"):
        raise CorruptSnapshotError(
            f"leaf {key!r} is stored as {arr.dtype}, which does not cast "
            f"losslessly to the template's {want}")
    arr = arr.astype(want, copy=False)
    if dev is None:
        return arr
    return torch.from_numpy(arr).to(dev)


def _restore_npz(npz_path: str, like: Any, *, keys: list | None = None,
                 checksums: dict | None = None, device=None) -> Any:
    """Load a flat-keyed npz back into the structure of ``like``,
    verifying manifest checksums when available."""
    flat = _load_npz(npz_path)
    pairs = [(_key(path), leaf)
             for path, leaf in _leaves_with_paths(like, sort=False)]
    ref_keys = [k for k, _ in pairs]
    if len(set(ref_keys)) != len(ref_keys):
        raise CorruptSnapshotError(
            f"restore template flattens to {len(set(ref_keys))} keyed "
            f"leaves but {len(ref_keys)} tree leaves — the template's "
            "structure cannot address the snapshot")
    _verify_flat(flat, keys if keys is not None else ref_keys, checksums,
                 npz_path)
    try:
        out = [_like_leaf(k, flat[k], leaf, device) for k, leaf in pairs]
    except KeyError as err:
        raise CorruptSnapshotError(
            f"{npz_path} has no leaf {err.args[0]!r} — the restore "
            "template does not match the snapshot's structure") from err
    return _rebuild(like, iter(out))


def _committed_path(directory: str, step: int) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return path


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, on any
    device including ``meta``, or of numpy arrays).  Each leaf comes back
    with ``like``'s dtype, as a tensor on ``device`` when given, else on
    ``like``'s device (a ``meta`` leaf: the CPU); the values are the
    stored ones, exactly.  Raises :class:`CorruptSnapshotError` (never
    half-loads) when the snapshot was torn after commit."""
    path = _committed_path(directory, step)
    meta = _load_manifest(directory, step)
    return _restore_npz(os.path.join(path, "arrays.npz"), like,
                        keys=meta.get("keys"),
                        checksums=meta.get("checksums"), device=device)


def restore_extras(directory: str, step: int, like: Any) -> Any:
    """Restore the snapshot's side payload (see ``save(..., extras=)``)
    into the structure of ``like``, each leaf on ``like``'s device (a
    ``meta`` leaf: the CPU).  Raises FileNotFoundError when the snapshot
    was written without extras — callers know from the metadata whether
    to expect one."""
    path = _committed_path(directory, step)
    npz = os.path.join(path, "extras.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"snapshot {path} has no extras payload")
    meta = _load_manifest(directory, step)
    return _restore_npz(npz, like, keys=meta.get("extra_keys"),
                        checksums=meta.get("extra_checksums"))


def restore_metadata(directory: str, step: int) -> dict:
    return _load_manifest(directory, step)["metadata"]


def verify_snapshot(directory: str, step: int) -> tuple[bool, str]:
    """End-to-end integrity check of one committed snapshot: manifest
    parses, payloads load, every manifest leaf is present, and every
    recorded checksum matches.  Snapshots written before checksums were
    recorded verify by loadability alone.  Returns (ok, reason)."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        return False, "no COMMITTED marker"
    try:
        meta = _load_manifest(directory, step)
        flat = _load_npz(os.path.join(path, "arrays.npz"))
        _verify_flat(flat, meta.get("keys", list(flat)),
                     meta.get("checksums"), os.path.join(path, "arrays.npz"))
        if meta.get("extra_keys"):
            eflat = _load_npz(os.path.join(path, "extras.npz"))
            _verify_flat(eflat, meta["extra_keys"],
                         meta.get("extra_checksums"),
                         os.path.join(path, "extras.npz"))
    except CorruptSnapshotError as err:
        return False, str(err)
    return True, ""


def latest_verified_step(directory: str) -> tuple[int | None, list]:
    """The newest committed snapshot that passes :func:`verify_snapshot`,
    walking newest-first; snapshots skipped on the way are returned as
    ``(step, reason)`` pairs so resumers can report what was lost."""
    skipped: list[tuple[int, str]] = []
    for step in reversed(committed_steps(directory)):
        ok, reason = verify_snapshot(directory, step)
        if ok:
            return step, skipped
        skipped.append((step, reason))
    return None, skipped
