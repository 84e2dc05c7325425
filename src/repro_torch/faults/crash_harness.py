"""Kill-at-every-round-boundary crash sweep for the pod driver.

The acceptance harness for crash-consistent recovery: for each round
boundary, a child training process is SIGKILLed at the checkpoint seam —
either just *after* a snapshot commits (``after``: the classic crash
between rounds) or *mid-write* (``mid``: the process dies with a partial
temp dir on disk and no commit, exercising the atomic temp+rename path) —
then restarted.  The restarted run must

* resume from the newest **verified** snapshot (a mid-write kill leaves
  only uncommitted garbage, so it falls back one boundary),
* finish sanitizer-clean (the child runs under ``--sanitize``; any
  protocol invariant violation is a non-zero exit), and
* reach a **bit-exact** final state: the final snapshot's per-array CRC32
  manifest and the host-loop continuation state (batch RNG) must equal an
  uninterrupted same-seed reference run's.  Checksums cover every leaf of
  the train state, so manifest equality *is* array equality.

Run directly (``python -m repro_torch.faults.crash_harness --rounds 6``,
on the card by default; ``--device cpu`` off it) or from pytest via
:func:`sweep` (``device="cpu"``).  ``--child`` is the internal re-exec
mode: it monkeypatches ``checkpoint.store.save`` to SIGKILL itself at the
target step, then drives ``repro_torch.launch.train.main``.

The torch port's copy of the JAX package's ``faults/crash_harness.py``;
its children run the port's pod driver on ``--device``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

from repro_torch.checkpoint import store

_SIGKILLED = -signal.SIGKILL


def _child_main(a) -> None:
    """Re-exec target: run pod training, dying at the kill step."""
    from repro_torch.launch import train

    real_save = store.save

    def killing_save(directory, step, tree, metadata=None, retain=3,
                     extras=None):
        if a.kill_mode == "mid" and step == a.kill_step:
            # die mid-write: a temp dir exists, nothing was committed —
            # exactly what a power cut during np.savez leaves behind
            os.makedirs(directory, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=directory,
                                   prefix=f".tmp_step_{step:08d}_")
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                f.write(b"partial write, never committed")
                f.flush()
                os.fsync(f.fileno())
            os.kill(os.getpid(), signal.SIGKILL)
        path = real_save(directory, step, tree, metadata=metadata,
                         retain=retain, extras=extras)
        if a.kill_mode == "after" and step == a.kill_step:
            os.kill(os.getpid(), signal.SIGKILL)
        return path

    store.save = killing_save
    argv = ["--mode", "pod", "--rounds", str(a.rounds),
            "--ckpt-dir", a.ckpt_dir, "--ckpt-every", str(a.ckpt_every),
            "--batch", "4", "--seq-len", "32", "--seed", str(a.seed),
            "--window", str(a.window), "--device", a.device,
            "--log-every", "1000000", "--sanitize"]
    if a.ckpt_flush:
        argv.append("--ckpt-flush")
    train.main(argv)


def _run_child(ckpt_dir: str, rounds: int, ckpt_every: int, seed: int,
               kill_step: int = -1, kill_mode: str = "after",
               timeout: float = 600.0, window: int = 2,
               ckpt_flush: bool = False,
               device: str = "cuda") -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "repro_torch.faults.crash_harness",
           "--child", "--ckpt-dir", ckpt_dir, "--rounds", str(rounds),
           "--ckpt-every", str(ckpt_every), "--seed", str(seed),
           "--kill-step", str(kill_step), "--kill-mode", kill_mode,
           "--window", str(window), "--device", device]
    if ckpt_flush:
        cmd.append("--ckpt-flush")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, env=env, timeout=timeout,
                          capture_output=True, text=True)
    if proc.returncode not in (0, _SIGKILLED):
        raise RuntimeError(
            f"crash-sweep child failed unexpectedly (exit "
            f"{proc.returncode}, kill_step={kill_step}, "
            f"kill_mode={kill_mode}):\n{proc.stdout}\n{proc.stderr}")
    return proc


def _final_fingerprint(ckpt_dir: str, rounds: int) -> dict:
    """Bit-exactness witness: the final snapshot's CRC32 manifest plus the
    host-loop RNG continuation state."""
    step, skipped = store.latest_verified_step(ckpt_dir)
    if step != rounds:
        raise RuntimeError(f"expected a verified final snapshot at step "
                           f"{rounds} in {ckpt_dir}, found {step} "
                           f"(skipped: {skipped})")
    meta = store._load_manifest(ckpt_dir, step)
    return {"checksums": meta["checksums"],
            "extra_checksums": meta.get("extra_checksums"),
            "rng_state": json.loads(json.dumps(
                meta["metadata"].get("rng_state")))}


def _assert_no_flush(proc: subprocess.CompletedProcess, case: str) -> None:
    """No-flush contract witness: the driver reports its save counters
    (``checkpoints: flush_saves=N noflush_saves=M``) — a run configured
    for checkpoint-without-flush must never have drained the pipeline
    for a save."""
    if "flush_saves=0 " not in proc.stdout:
        raise RuntimeError(
            f"{case}: expected checkpoint-without-flush (flush_saves=0) "
            f"but the driver reported otherwise:\n{proc.stdout}")


def sweep(boundaries=None, *, rounds: int = 4, ckpt_every: int = 1,
          seed: int = 0, kill_modes=("after", "mid"),
          workdir: str | None = None, verbose: bool = False,
          window: int = 2, ckpt_flush: bool = False,
          device: str = "cuda") -> dict:
    """Kill a pod run at each checkpoint boundary, resume it, and verify
    bit-exact, sanitizer-clean continuation against an uninterrupted
    reference.  Returns the per-case results dict (raises on any
    divergence).

    ``window`` sets the child's pipeline depth; with the default
    ``ckpt_flush=False`` the children save via checkpoint-without-flush
    (the sweep asserts no full-drain save point ever happened), so a
    window=4 sweep is the acceptance run for deferred handle saves.
    ``device`` is the children's ``--device``."""
    if boundaries is None:
        boundaries = list(range(ckpt_every, rounds + 1, ckpt_every))
    tmp_ctx = tempfile.TemporaryDirectory() if workdir is None else None
    base = workdir if workdir is not None else tmp_ctx.name
    try:
        ref_dir = os.path.join(base, "reference")
        ref_proc = _run_child(ref_dir, rounds, ckpt_every, seed,
                              window=window, ckpt_flush=ckpt_flush,
                              device=device)
        if ref_proc.returncode != 0:
            raise RuntimeError(
                f"reference run exited {ref_proc.returncode}")
        if not ckpt_flush:
            _assert_no_flush(ref_proc, "reference")
        ref = _final_fingerprint(ref_dir, rounds)
        results = {}
        for mode in kill_modes:
            for s in boundaries:
                case = f"{mode}@{s}"
                d = os.path.join(base, f"kill_{mode}_{s}")
                killed = _run_child(d, rounds, ckpt_every, seed,
                                    kill_step=s, kill_mode=mode,
                                    window=window, ckpt_flush=ckpt_flush,
                                    device=device)
                if killed.returncode != _SIGKILLED:
                    raise RuntimeError(
                        f"{case}: child was not SIGKILLed (exit "
                        f"{killed.returncode}) — the kill step never fired")
                resumed = _run_child(d, rounds, ckpt_every, seed,
                                     window=window, ckpt_flush=ckpt_flush,
                                     device=device)
                if resumed.returncode != 0:
                    raise RuntimeError(f"{case}: resumed run exited "
                                       f"{resumed.returncode} (sanitizer "
                                       "violation or crash)")
                if not ckpt_flush:
                    _assert_no_flush(resumed, case)
                got = _final_fingerprint(d, rounds)
                if got != ref:
                    raise RuntimeError(
                        f"{case}: resumed run is NOT bit-exact with the "
                        f"reference —\n  ref: {ref}\n  got: {got}")
                results[case] = "bit-exact"
                if verbose:
                    print(f"crash sweep {case}: resumed bit-exact, "
                          "sanitizer-clean")
        return {"rounds": rounds, "boundaries": list(boundaries),
                "kill_modes": list(kill_modes), "window": window,
                "ckpt_flush": ckpt_flush, "device": device,
                "cases": results}
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--child", action="store_true",
                   help="internal: run one (possibly self-killing) child")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--ckpt-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kill-step", type=int, default=-1,
                   help="checkpoint step to SIGKILL at (-1: never)")
    p.add_argument("--kill-mode", default="after", choices=("after", "mid"))
    p.add_argument("--window", type=int, default=2,
                   help="pipeline window for the child runs (4+ exercises "
                        "deferred checkpoint-without-flush saves)")
    p.add_argument("--ckpt-flush", action="store_true", dest="ckpt_flush",
                   help="children drain the pipeline at every save (the "
                        "legacy flush saver) instead of the default "
                        "checkpoint-without-flush")
    p.add_argument("--device", default="cuda",
                   help="torch device of the children's step (cuda, or "
                        "cpu for the kernels' plain versions)")
    p.add_argument("--boundaries", default=None,
                   help="comma-separated kill boundaries (default: every "
                        "checkpoint step)")
    a = p.parse_args()
    if a.child:
        if not a.ckpt_dir:
            raise SystemExit("--child requires --ckpt-dir")
        _child_main(a)
        return
    boundaries = [int(x) for x in a.boundaries.split(",")] \
        if a.boundaries else None
    out = sweep(boundaries, rounds=a.rounds, ckpt_every=a.ckpt_every,
                seed=a.seed, verbose=True, window=a.window,
                ckpt_flush=a.ckpt_flush, device=a.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
