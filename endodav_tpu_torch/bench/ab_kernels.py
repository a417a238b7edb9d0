"""Time the kernel phases of two or more checkouts of the repository on
one card, in turns (A, B, B, A; with three, A, B, C, C, B, A; that
sequence ``--rounds`` times), with each checkout's own `chip_smoke.py` and
kernels.

    python3 endodav_tpu_torch/bench/ab_kernels.py DIR_A DIR_B [DIR_C ...] \
        [--phases temporal,mlp,tattn] [--iters N] [--rounds N]

Phases: temporal, mlp, tattn, flash, rcu, warp, splat, train
(comma-separated).

Each run is a fresh process started in the checkout's directory: it
imports that checkout's `chip_smoke.py` (and so its kernels, built there
on first use), runs the chosen phases (`check_temporal`,
`check_fused_mlp`, `check_temporal_attention`, `check_flash`,
`check_fused_rcu`; `warp` runs `check_warps` and `check_warps_cp`,
whose rows hold a forward and a backward kernel each; `splat` runs
`check_splat`, one row) with TF32 off for the
library yardsticks, as that `chip_smoke.py` runs them (its `ieee_f32()`
context, or the process's switches where it has none), and prints each
row as JSON.  `train` runs that checkout's `run_training` (the full-width
training step under the entry point's own precision policy, TRAIN_STEPS
steps and then its ENDODAV_WARP_CP=1 steps) on one synthetic tree written
once for all runs: its row holds the median ms/step, the last
ENDODAV_WARP_CP=1 step's ms, and the splat's ms on the step's own
occlusion maps where that checkout times them.  ``--iters`` sets the launches each timing averages
(`chip_smoke.time_calls`' default, 5, otherwise): kernels of a tenth of a
millisecond vary by 10% or more over 5 launches.  The last lines
are, for every row, the kernel's mean ms in each checkout over its two
runs (`a_ms`, `b_ms`, ... in the order given; `a_runs`, ... each run's),
the library call's, and the
error against the plain version: the comparison of a change with its
parent, or of variants of a kernel, that `PERF.md` quotes.  Needs a
CUDA card; it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

PHASES = {"temporal": ["check_temporal"], "mlp": ["check_fused_mlp"],
          "tattn": ["check_temporal_attention"], "flash": ["check_flash"],
          "rcu": ["check_fused_rcu"], "warp": ["check_warps", "check_warps_cp"],
          "splat": ["check_splat"], "train": ["run_training"]}
TRAIN_STEPS = 6  # the row's ms/step is the median of steps 2-6

RUN = """
import contextlib, json, os, sys, torch
import chip_smoke as s
iters = int(sys.argv.pop(1))
if iters:
    s.time_calls.__defaults__ = (iters,)
if not hasattr(s, "ieee_f32"):  # older checkouts: TF32 off for the process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
for phase in sys.argv[1:]:
    if phase == "run_training":
        t = s.run_training(dev, os.environ["AB_SCARED_ROOT"],
                           steps=int(os.environ["AB_TRAIN_STEPS"]))
        rows = {"shape": "vits 256x320 T=16 step", "ms": t["ms_per_step"],
                "cp_ms": t["cp_step_ms"][-1],
                "splat": [{"ms": a.get("ms"), "rel_occ": a["rel_occ"]} for a in t["splat"]]}
    else:
        with getattr(s, "ieee_f32", contextlib.nullcontext)():
            rows = getattr(s, phase)(dev)
    rows = rows[0] if isinstance(rows, tuple) else rows
    rows = [rows] if isinstance(rows, dict) else rows
    for r in rows:
        print("AB " + json.dumps({"phase": phase, **r}), flush=True)
"""


def run(tree: str, phases: list[str], iters: int = 0, env=None) -> list[dict]:
    res = subprocess.run([sys.executable, "-c", RUN, str(iters), *phases], cwd=tree,
                         capture_output=True, text=True, timeout=1800, env=env)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: exit {res.returncode}\n{res.stdout[-4000:]}\n"
                         f"{res.stderr[-4000:]}")
    return [json.loads(line[3:]) for line in res.stdout.splitlines() if line.startswith("AB ")]


def timed(r: dict):
    """(key, kernel ms, library ms, error) of each kernel a row times: one
    for the rows with a dtype and the splat's (its map's relative error),
    the forward and the backward of a warp row (key: the call, shape and
    planes or not; the error: the output's, or the largest of the
    coordinate gradients' and d_img's relative one); a training row's
    step, ENDODAV_WARP_CP=1 step and splat on each occlusion map (no
    library call)."""
    if r["phase"] == "run_training":
        yield (r["phase"], "step", "float32"), r["ms"], None, 0.0
        yield (r["phase"], "step ENDODAV_WARP_CP=1", "float32"), r["cp_ms"], None, 0.0
        for i, a in enumerate(r["splat"]):
            if a["ms"] is not None:
                yield (r["phase"], f"splat, step map {i}", "float32"), a["ms"], None, a["rel_occ"]
        return
    if "fwd" not in r:
        err = r["err"] if "err" in r else r["rel_occ"]
        yield (r["phase"], r["shape"], r.get("dtype", "float32")), r["ms"], r["library_ms"], err
        return
    errs = {k: v for k, v in r.items()
            if k.startswith(("err_", "rel_dimg")) and not k.startswith("err_dimg")}
    fwd = max((v for k, v in errs.items() if k.startswith("err_out")), default=0.0)
    bwd = max((v for k, v in errs.items() if not k.startswith("err_out")), default=0.0)
    for kind, err in (("fwd", fwd), ("bwd", bwd)):
        yield ((r["phase"], f"{r['call']} {kind}, {r['shape']}", "float32"), r[kind]["ms"],
               r[kind]["library_ms"], err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="two or more checkouts")
    ap.add_argument("--phases", default="temporal,mlp,tattn")
    ap.add_argument("--iters", type=int, default=0,
                    help="launches a timing averages (0: the checkout's default)")
    ap.add_argument("--rounds", type=int, default=1, help="times the sequence of runs is made")
    args = ap.parse_args()
    phases = [f for p in args.phases.split(",") for f in PHASES[p]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if len(args.trees) < 2:
        ap.error("give two or more checkouts")
    labels = dict(zip(args.trees, "abcdefghijklmnopqrstuvwxyz"))
    runs = {tree: [] for tree in args.trees}
    with tempfile.TemporaryDirectory(prefix="scared_synth_", dir=os.getcwd()) as tmp:
        env = dict(os.environ, AB_SCARED_ROOT=tmp, AB_TRAIN_STEPS=str(TRAIN_STEPS))
        if "run_training" in phases:  # one synthetic tree for every run
            subprocess.run([sys.executable, "-c", "import sys, chip_smoke as s; "
                            "s.write_scared_tree(sys.argv[1])", tmp], cwd=args.trees[0],
                           check=True, timeout=600)
        for tree in (args.trees + args.trees[::-1]) * args.rounds:
            rows = run(tree, phases, args.iters, env)
            runs[tree].append(rows)
            for r in rows:
                print(f"[{os.path.basename(os.path.normpath(tree))}] {json.dumps(r)}", flush=True)
    table = {}
    for tree, label in labels.items():
        for rows in runs[tree]:
            for k, ms, library_ms, err in (t for r in rows for t in timed(r)):
                e = table.setdefault(k, {})
                e.setdefault(f"{label}_ms", []).append(ms)
                if library_ms is not None:
                    e.setdefault("library_ms", []).append(library_ms)
                e[f"{label}_err"] = max(e.get(f"{label}_err", 0.0), err)
    for k, e in table.items():
        out = {"phase": k[0], "shape": k[1], "dtype": k[2]}
        for name, vals in e.items():
            out[name] = sum(vals) / len(vals) if isinstance(vals, list) else vals
            if name.endswith("_ms") and name != "library_ms":
                out[name[:-3] + "_runs"] = vals
        print("[ab] " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
