"""Time the kernel phases of two or more checkouts of the repository on
one card, in turns (A, B, B, A; with three, A, B, C, C, B, A), with each
checkout's own `chip_smoke.py` and kernels.

    python3 endodav_tpu_torch/bench/ab_kernels.py DIR_A DIR_B [DIR_C ...] \
        [--phases temporal,mlp,tattn]

Phases: temporal, mlp, tattn, flash, rcu, warp (comma-separated).

Each run is a fresh process started in the checkout's directory: it
imports that checkout's `chip_smoke.py` (and so its kernels, built there
on first use), runs the chosen phases (`check_temporal`,
`check_fused_mlp`, `check_temporal_attention`, `check_flash`,
`check_fused_rcu`; `warp` runs `check_warps` and `check_warps_cp`,
whose rows hold a forward and a backward kernel each) with TF32 off for the
library yardsticks, as that `chip_smoke.py` runs them (its `ieee_f32()`
context, or the process's switches where it has none), and prints each
row as JSON.  The last lines
are, for every row, the kernel's mean ms in each checkout over its two
runs (`a_ms`, `b_ms`, ... in the order given), the library call's, and the
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

PHASES = {"temporal": ["check_temporal"], "mlp": ["check_fused_mlp"],
          "tattn": ["check_temporal_attention"], "flash": ["check_flash"],
          "rcu": ["check_fused_rcu"], "warp": ["check_warps", "check_warps_cp"]}

RUN = """
import contextlib, json, sys, torch
import chip_smoke as s
if not hasattr(s, "ieee_f32"):  # older checkouts: TF32 off for the process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
for phase in sys.argv[1:]:
    with getattr(s, "ieee_f32", contextlib.nullcontext)():
        rows = getattr(s, phase)(dev)
    rows = rows[0] if isinstance(rows, tuple) else rows
    for r in rows:
        print("AB " + json.dumps({"phase": phase, **r}), flush=True)
"""


def run(tree: str, phases: list[str]) -> list[dict]:
    res = subprocess.run([sys.executable, "-c", RUN, *phases], cwd=tree, capture_output=True,
                         text=True, timeout=1800)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: exit {res.returncode}\n{res.stdout[-4000:]}\n"
                         f"{res.stderr[-4000:]}")
    return [json.loads(line[3:]) for line in res.stdout.splitlines() if line.startswith("AB ")]


def timed(r: dict):
    """(key, kernel ms, library ms, error) of each kernel a row times: one
    for the rows with a dtype, the forward and the backward of a warp row
    (key: the call, shape and planes or not; the error: the output's, or
    the largest of the coordinate gradients' and d_img's relative one)."""
    if "fwd" not in r:
        yield (r["phase"], r["shape"], r["dtype"]), r["ms"], r["library_ms"], r["err"]
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
    args = ap.parse_args()
    phases = [f for p in args.phases.split(",") for f in PHASES[p]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if len(args.trees) < 2:
        ap.error("give two or more checkouts")
    labels = dict(zip(args.trees, "abcdefghijklmnopqrstuvwxyz"))
    runs = {tree: [] for tree in args.trees}
    for tree in args.trees + args.trees[::-1]:
        rows = run(tree, phases)
        runs[tree].append(rows)
        for r in rows:
            print(f"[{os.path.basename(os.path.normpath(tree))}] {json.dumps(r)}", flush=True)
    table = {}
    for tree, label in labels.items():
        for rows in runs[tree]:
            for k, ms, library_ms, err in (t for r in rows for t in timed(r)):
                e = table.setdefault(k, {})
                e.setdefault(f"{label}_ms", []).append(ms)
                e.setdefault("library_ms", []).append(library_ms)
                e[f"{label}_err"] = max(e.get(f"{label}_err", 0.0), err)
    for k, e in table.items():
        out = {"phase": k[0], "shape": k[1], "dtype": k[2]}
        for name, vals in e.items():
            out[name] = sum(vals) / len(vals) if isinstance(vals, list) else vals
        print("[ab] " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
