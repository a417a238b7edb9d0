"""Tensor and data parallelism over four cards of one host, against one card.

    python3 multi_card.py

Run from the root of the repository, beside `chip_smoke.py`, whose helpers
it uses.  Needs four CUDA cards (NCCL, a card a rank).  On card 0 alone it
times and keeps the references: a 32-frame 518x644 window of vitl and of vits
(merged, the seed's weights; three forwards each, ms per frame), the
window path over one 64-frame 512x640 sequence at ``--chunk_windows 4``,
and three steps of `scripts/train_video.sh`'s flags at ``--batch_size 4``
on a synthetic tree of 4 sequences of 60 256x320 frames.  Then, through
`parallel.launch`, the TP forward at g=2 (vitl, vits) and g=4 (vitl; 6
heads do not split 4 ways), and at four ranks the window path at data=4
and the three steps at ``--mesh_shape data=4``: ms per frame or step
beside one card, |Δdisp| against one card, the steps' losses.  Last,
`evaluate_depth_video` as a user runs it, in a process of its own, with
``--serve_mesh data=4`` (the CLI starts the four ranks) and without the
flag, on the tree's val split.  Fails unless every TP and window output
is within `MODEL_TOL` of one card, the steps' losses within
`DP_LOSS_RTOL` of one card's, and the two CLI runs' printed metrics agree
to CLI_RTOL.  Prints the card's name and power limit and one JSON line.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as C
from endodav_tpu_torch import parallel
from endodav_tpu_torch.kernels import _build

FOUR = [f"cuda:{i}" for i in range(4)]
VITL = ["--encoder", "vitl", *C.HEADLINE]
# the CLI prints its metrics to 4 decimals: two runs within 1e-4 relative
# print values that differ by at most that plus the two roundings
CLI_RTOL = 2e-4


def cli_metrics(data, splits, *extra):
    """`evaluate_depth_video` in a new process on the tree's val split at
    the 518x644 headline (4 windows a chunk): its printed metrics by name,
    and its seconds."""
    args = [sys.executable, "-m", "endodav_tpu_torch.cli.evaluate_depth_video", "--data_path",
            data, "--model_type", "endodav", "--eval_split", "scared_video", *C.HEADLINE,
            "--chunk_windows", "4", "--seed", str(C.SEED), *extra]
    t0 = time.perf_counter()
    run = subprocess.run(args, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "ENDODAV_TPU_SPLITS_DIR": splits})
    seconds = time.perf_counter() - t0
    C.require(run.returncode == 0, f"evaluate_depth_video {extra}: exit {run.returncode}\n"
              f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("abs_rel=")]
    C.require(len(lines) == 1, f"evaluate_depth_video {extra}: no metric line in "
              f"{run.stdout[-2000:]}")
    found = dict(re.findall(r"(\w+)=(-?[0-9.]+|nan)", lines[0]))
    return {k: float(v) for k, v in found.items()}, seconds, run.stdout


def rank_fn(path, g):
    """TP at g ranks (vitl, vits where g divides 6) and, at g == 4, the
    window path at data=4 and DP_STEPS training steps at data=4."""
    import torch.distributed as dist
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth
    from endodav_tpu_torch.parallel.tp import build_tp_mesh, tp_local_model, tp_window_forward
    spec = torch.load(path, weights_only=False)
    rank = dist.get_rank()
    device = torch.device("cuda", rank)
    out = {"ms": {}, "err": {}}
    mesh = build_tp_mesh(g)
    for label, args, heads in (("vitl", VITL, 16), ("vits", C.HEADLINE, 6)):
        if heads % g:
            continue
        model = engine.build_depth_model(C.eval_options(args), device)
        x = C._tp_input(32, True).to(device)
        fwd = tp_window_forward(tp_local_model(model, g), model.state_dict(), mesh, heads)
        fwd(x)
        times = []
        for _ in range(3):
            y, ms = C._timed(lambda: fwd(x), device)
            times.append(ms / 32)
        out["ms"][f"TP g={g} {label}"] = times
        out["err"][f"TP g={g} {label}"] = C._disp_err(y, spec["ref"][label])
        del model, fwd
        torch.cuda.empty_cache()
    if g == 4:
        frames = C.synthetic_sequences(n_seq=1)[0]["colors"]
        model = engine.build_depth_model(C.eval_options(C.HEADLINE), device)
        fwd = engine.depth_window_forward(model)
        mesh4 = parallel.build_mesh("data=4")
        infer_video_depth(fwd, frames, image_shape=(518, 644), chunk_windows=4, device=device,
                          mesh=mesh4)
        disp, ms = C._timed(lambda: infer_video_depth(fwd, frames, image_shape=(518, 644),
                                                      chunk_windows=4, device=device,
                                                      mesh=mesh4), device)
        out["ms"]["window data=4"] = ms / len(frames)
        out["err"]["window data=4"] = C._disp_err(disp, spec["ref"]["window"])
        del model, fwd
        torch.cuda.empty_cache()
        trainer = C._dp_trainer(device, spec["data"], spec["splits"], "--batch_size", "4",
                                "--mesh_shape", "data=4")
        losses, times = [], []
        for batch in C.first_batches(trainer, 3):
            sc, ms = C._timed(lambda: trainer.train_one_batch(batch), device)
            losses.append((float(sc["loss"]), float(sc["loss_0"])))
            times.append(ms)
        out["ms"]["data=4 step (B=4)"] = times
        out["loss_rel"] = max(abs(a - b) / max(1, abs(b)) for la, lb in zip(losses, spec["losses"])
                              for a, b in zip(la, lb))
        out["losses"] = losses
    if rank == 0:
        torch.save(out, f"{path}.g{g}")


if __name__ == "__main__":
    _build.library()
    card = C.card_line()
    print(card, torch.cuda.device_count(), flush=True)
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth
    device = torch.device("cuda", 0)
    ref, one = {}, {}
    for label, args in (("vitl", VITL), ("vits", C.HEADLINE)):
        model = C.own_policy(label, engine.build_depth_model, C.eval_options(args), device)
        x = C._tp_input(32, True).to(device)
        with torch.inference_mode():
            model(x)
            times = []
            for _ in range(3):
                y, ms = C._timed(lambda: model(x), device)
                times.append(ms / 32)
        ref[label], one[f"one card {label} window"] = y[("disp", 0)].float().cpu(), times
        del model
        torch.cuda.empty_cache()
    frames = C.synthetic_sequences(n_seq=1)[0]["colors"]
    model = engine.build_depth_model(C.eval_options(C.HEADLINE), device)
    fwd = engine.depth_window_forward(model)
    infer_video_depth(fwd, frames, image_shape=(518, 644), chunk_windows=4, device=device)
    disp, ms = C._timed(lambda: infer_video_depth(fwd, frames, image_shape=(518, 644),
                                                  chunk_windows=4, device=device), device)
    ref["window"], one["one card window path"] = disp, ms / len(frames)
    del model, fwd
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="four_", dir=os.getcwd()) as root:
        data, splits = C.write_script_tree(root, n_frames=60, h=256, w=320)
        trainer = C._dp_trainer(device, data, splits, "--batch_size", "4")
        losses, times = [], []
        for batch in C.first_batches(trainer, 3):
            sc, ms = C._timed(lambda: trainer.train_one_batch(batch), device)
            losses.append((float(sc["loss"]), float(sc["loss_0"])))
            times.append(ms)
        one["one card step (B=4)"] = times
        del trainer
        torch.cuda.empty_cache()
        path = os.path.join(root, "four.pt")
        torch.save({"ref": ref, "data": data, "splits": splits, "losses": losses}, path)
        print("one card", one, flush=True)
        res = {}
        for g in (2, 4):
            t = time.perf_counter()
            parallel.launch(rank_fn, (path, g), n=g, devices=FOUR[:g], timeout=600)
            res[g] = torch.load(f"{path}.g{g}", weights_only=False)
            print(f"g={g} launch {time.perf_counter() - t:.1f} s: {res[g]}", flush=True)
        one_cli, one_s, _ = cli_metrics(data, splits)
        four_cli, four_s, four_out = cli_metrics(data, splits, "--serve_mesh", "data=4")
        C.require("[parallel] backend=nccl world=4" in four_out,
                  "evaluate_depth_video --serve_mesh data=4: no NCCL world of four")
        cli_rel = max(abs(four_cli[k] - v) / max(1.0, abs(v)) for k, v in one_cli.items()
                      if v == v)
        cli = {"metrics": four_cli, "rel": cli_rel, "seconds": {"no flag": one_s,
                                                                  "data=4": four_s}}
        print(f"evaluate_depth_video --serve_mesh data=4 against no flag: {cli}", flush=True)
    errs = {k: v for r in res.values() for k, v in r["err"].items()}
    for label, (worst, _) in errs.items():
        C.require(worst <= C.MODEL_TOL, f"{label}: max |Δdisp| {worst} against one card, "
                  f"above {C.MODEL_TOL}")
    C.require(res[4]["loss_rel"] <= C.DP_LOSS_RTOL,
              f"data=4 steps: losses {res[4]['losses']} against one card's {losses}")
    C.require(cli_rel <= CLI_RTOL, f"evaluate_depth_video --serve_mesh data=4: metrics "
              f"{four_cli} against {one_cli}")
    print(json.dumps({"card": card, "one": one, "ranks": {str(k): v for k, v in res.items()},
                      "cli": cli}, default=str))
    print("FOUR OK")
