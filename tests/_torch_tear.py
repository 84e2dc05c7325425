"""Damage a committed snapshot in place, as the JAX package's
``faults.inject.tear_snapshot`` does (the port's fault plane, which owns
that helper, is not ported yet).

``truncate`` cuts ``arrays.npz`` in half (load fails), ``bitflip`` flips
one bit mid-file (only a checksum catches it), ``manifest`` mangles
``tree.json`` (parse fails).
"""
import os

MODES = ("truncate", "bitflip", "manifest")


def tear(directory: str, step: int, mode: str) -> str:
    snap = os.path.join(directory, f"step_{step:08d}")
    arrays = os.path.join(snap, "arrays.npz")
    if mode == "truncate":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as fh:
            fh.truncate(max(1, size // 2))
    elif mode == "bitflip":
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as fh:
            fh.seek(size // 2)
            byte = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0x40]))
    elif mode == "manifest":
        with open(os.path.join(snap, "tree.json"), "w") as fh:
            fh.write("{ torn")
    else:
        raise ValueError(f"unknown tear mode {mode!r}")
    return snap
