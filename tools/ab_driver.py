#!/usr/bin/env python3
"""Time the port's pod driver from two source trees in turns, on one card.

    python3 tools/ab_driver.py TREE_A TREE_B

Turns ABBAABBA.  Each turn is a fresh process that imports ``repro_torch``
from that tree's ``src`` and runs ``train.run_pod`` for five rounds at
window 2 on ``chip_smoke.py``'s smollm-135m main path (full width and
depth, its flags), TF32 off.  A turn prints one
``[ab]`` line: the tree, steady tok/s (rounds 2..N, first to last
completion, on the card's clock), the host seconds inside ``step()`` per
round, and the executor's device seconds per round.  The last line gives
each tree's means over its turns.  Interleaving the turns spreads the
host's drift over both trees.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
ARCH, ORDER, ROUNDS, WINDOW = "smollm-135m", "ABBAABBA", 5, 2

CHILD = r"""
import json, sys, torch
import repro_torch
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
args = train.build_parser().parse_args(json.loads(sys.argv[1]))
out = train.run_pod(args)
stats = out["round_stats"]
print("[ab-result] " + json.dumps({
    "module": repro_torch.__file__, "steady_tok_s": out["steady_tok_s"],
    "step_s": [s.dispatch_s for s in stats],
    "device_s_per_round": out["executor"]["device_s_per_round"],
    "history": out["history"]}), flush=True)
"""


def turn(tree: Path, flags: list[str]) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    done = subprocess.run([sys.executable, "-c", CHILD, json.dumps(flags)],
                          cwd=tree, env=env, capture_output=True, text=True,
                          check=False)
    if done.returncode != 0:
        raise RuntimeError(f"{tree}: exit {done.returncode}\n"
                           f"{done.stderr[-4000:]}")
    line = [x for x in done.stdout.splitlines()
            if x.startswith("[ab-result] ")][-1]
    return json.loads(line.removeprefix("[ab-result] "))


def main() -> int:
    import chip_smoke
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a", type=Path)
    p.add_argument("tree_b", type=Path)
    a = p.parse_args()
    trees = {"A": a.tree_a.resolve(), "B": a.tree_b.resolve()}
    flags = chip_smoke.MAIN_ARGS + chip_smoke.MAIN_PATHS[ARCH] + [
        "--rounds", str(ROUNDS), "--window", str(WINDOW)]
    print(f"[ab] {ARCH} flags {' '.join(flags)} | A {trees['A']} | "
          f"B {trees['B']} | nvidia-smi: {chip_smoke.smi_name_power()}",
          flush=True)
    runs = {"A": [], "B": []}
    for i, t in enumerate(ORDER):
        r = turn(trees[t], flags)
        runs[t].append(r)
        print(f"[ab] turn {i + 1} {t}: steady {r['steady_tok_s']!r} tok/s | "
              f"step() s per round {[round(s, 4) for s in r['step_s']]} | "
              f"device s per round {r['device_s_per_round']!r} | "
              f"{r['module']}", flush=True)
    hist = {t: [json.dumps(r["history"]) for r in rs] for t, rs in
            runs.items()}
    same = len({h for hs in hist.values() for h in hs}) == 1
    summary = {t: {"turns": len(rs),
                   "steady_tok_s_mean": statistics.mean(
                       r["steady_tok_s"] for r in rs),
                   "step_s_mean": statistics.mean(
                       s for r in rs for s in r["step_s"][1:]),
                   "device_s_per_round_mean": statistics.mean(
                       r["device_s_per_round"] for r in rs)}
               for t, rs in runs.items()}
    print(f"[ab] histories identical across all turns: {same}")
    print("[ab] " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
