"""Time the kernel phases of two checkouts of the repository on one card,
in turns (A, B, B, A), with each checkout's own `chip_smoke.py` and
kernels.

    python3 endodav_tpu_torch/bench/ab_kernels.py DIR_A DIR_B [--phases temporal,mlp,tattn]

Phases: temporal, mlp, tattn, flash, rcu (comma-separated).

Each run is a fresh process started in the checkout's directory: it
imports that checkout's `chip_smoke.py` (and so its kernels, built there
on first use), runs the chosen phases (`check_temporal`,
`check_fused_mlp`, `check_temporal_attention`, `check_flash`,
`check_fused_rcu`) with TF32 off for the
library yardsticks, as that `chip_smoke.py` runs them (its `ieee_f32()`
context, or the process's switches where it has none), and prints each
row as JSON.  The last lines
are, for every row, the kernel's mean ms in each checkout over its two
runs, the library call's, and the error against the plain version: the
comparison of a change with its parent that `PERF.md` quotes.  Needs a
CUDA card; it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {"temporal": "check_temporal", "mlp": "check_fused_mlp",
          "tattn": "check_temporal_attention", "flash": "check_flash", "rcu": "check_fused_rcu"}

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--phases", default="temporal,mlp,tattn")
    args = ap.parse_args()
    phases = [PHASES[p] for p in args.phases.split(",")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    runs = {args.a: [], args.b: []}
    for tree in (args.a, args.b, args.b, args.a):
        rows = run(tree, phases)
        runs[tree].append(rows)
        for r in rows:
            print(f"[{os.path.basename(os.path.normpath(tree))}] {json.dumps(r)}", flush=True)
    key = lambda r: (r["phase"], r["shape"], r["dtype"])  # noqa: E731
    table = {}
    for label, tree in (("a", args.a), ("b", args.b)):
        for rows in runs[tree]:
            for r in rows:
                e = table.setdefault(key(r), {})
                e.setdefault(f"{label}_ms", []).append(r["ms"])
                e.setdefault("library_ms", []).append(r["library_ms"])
                e[f"{label}_err"] = max(e.get(f"{label}_err", 0.0), r["err"])
    for k, e in table.items():
        out = {"phase": k[0], "shape": k[1], "dtype": k[2]}
        for name, vals in e.items():
            out[name] = sum(vals) / len(vals) if isinstance(vals, list) else vals
        print("[ab] " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
