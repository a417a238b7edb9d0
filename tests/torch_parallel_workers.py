"""Rank functions of the parallel tests (`tests/test_torch_parallel_*.py`).

`endodav_tpu_torch.parallel.launch` starts `run_jobs` in fresh processes
(start method ``spawn``), which import this module and nothing of JAX; one
world a test module and size runs all of that module's jobs at that size.
Every job reads its inputs from ``path`` (a `torch.save` file the test
wrote, which several jobs may share) and rank 0 writes its results to
``out`` (the training step: see `train_step`).
"""

import os

import numpy as np
import torch

torch.set_num_threads(1)


def _setenv(env: dict):
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def run_jobs(jobs: list):
    """Each ``(name, args, env)`` of ``jobs`` in turn: this module's function
    ``name(*args)`` with the environment variables ``env`` set for it."""
    for name, args, env in jobs:
        saved = {k: os.environ.get(k) for k in env}
        _setenv(env)
        try:
            globals()[name](*args)
        finally:
            _setenv(saved)


def tp_forward(path: str, out: str, g: int):
    """The TP forward at g ranks of the model in ``path`` on its input."""
    from endodav_tpu_torch.parallel.tp import build_tp_mesh, tp_local_model, tp_window_forward

    spec = torch.load(path, weights_only=False)
    model = spec["cls"](**spec["config"])
    model.load_state_dict(spec["state"])
    mesh = build_tp_mesh(g)
    fwd = tp_window_forward(tp_local_model(model, g), spec["state"], mesh,
                            num_heads=spec["num_heads"])
    y = fwd(spec["x"])
    if mesh.rank == 0:
        torch.save(y, out)


def tp_dedup(path: str, out: str, g: int, data: int):
    """`infer_video_depth` over `TPDedupWindowForward` on a (data, model) mesh."""
    from endodav_tpu_torch.eval.video_inference import infer_video_depth
    from endodav_tpu_torch.parallel.tp import (build_tp_mesh, TPDedupWindowForward,
                                               tp_local_model)

    spec = torch.load(path, weights_only=False)
    model = spec["cls"](**spec["config"])
    model.load_state_dict(spec["state"])
    mesh = build_tp_mesh(g, data=data)
    dedup = TPDedupWindowForward(tp_local_model(model, g), spec["state"], mesh, num_heads=6)
    disp = infer_video_depth(None, spec["frames"], image_shape=spec["shape"], chunk_windows=2,
                             device="cpu", dedup=dedup)
    if mesh.rank == 0:
        torch.save(disp, out)


def window_dp(path: str, out: str, data: int):
    """`infer_video_depth`'s window path over a data mesh of ``data`` ranks."""
    from endodav_tpu_torch.eval import engine
    from endodav_tpu_torch.eval.video_inference import infer_video_depth
    from endodav_tpu_torch.parallel import build_mesh

    spec = torch.load(path, weights_only=False)
    model = spec["cls"](**spec["config"])
    model.load_state_dict(spec["state"])
    mesh = build_mesh(f"data={data}")
    disp = infer_video_depth(engine.depth_window_forward(model.eval()), spec["frames"],
                             image_shape=spec["shape"], chunk_windows=2, device="cpu",
                             mesh=mesh)
    if mesh.rank == 0:
        torch.save(disp, out)


def tp_stream(path: str, out: str, g: int, data: int):
    """`DepthStreamer` over the TP dedup pipeline, every rank pushing the
    same frames."""
    from endodav_tpu_torch.eval.streaming import DepthStreamer
    from endodav_tpu_torch.parallel.tp import (build_tp_mesh, TPDedupWindowForward,
                                               tp_local_model)

    spec = torch.load(path, weights_only=False)
    model = spec["cls"](**spec["config"])
    model.load_state_dict(spec["state"])
    mesh = build_tp_mesh(g, data=data)
    dedup = TPDedupWindowForward(tp_local_model(model, g), spec["state"], mesh, num_heads=6)
    s = DepthStreamer(None, image_shape=spec["shape"], dedup=dedup, device="cpu")
    got = []
    for f in spec["frames"]:
        got.extend(s.push(f))
    got.extend(s.flush())
    if mesh.rank == 0:
        torch.save(np.stack(got), out)


def with_motion(trainer, seed: int = 21):
    """Flows of ~0.7 px and a camera motion: the position convs' and the
    pose head's biases drawn from ``seed`` (`tests/test_torch_train_step.py:
    _with_motion`), so that no warp samples at integer positions."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for comp, key, std in [("position", f"convs.position_conv_{s}.bias", 0.7)
                               for s in range(4)] + [("pose", "convs.pose_2.bias", 10.0)]:
            p = dict(trainer.mods[comp].named_parameters())[key]
            p.copy_(torch.from_numpy(rng.normal(0, std, p.shape).astype(np.float32)))


def train_step(path: str, data: int):
    """One `Trainer.train_one_batch` at ``--mesh_shape data=<data>`` from the
    trainer's seeded init (`with_motion`) on this rank's slice of the global
    batch in ``path``.  data=1 saves the losses, the weights and buffers
    after the step and the gradients to ``path + ".d1"``; with data > 1
    each rank compares its own with that file and rank 0's, and rank 0
    saves the largest differences to ``path + ".d<data>"``."""
    import torch.distributed as dist

    from endodav_tpu_torch.options import EndoDAVOptions
    from endodav_tpu_torch.parallel import shard_batch
    from endodav_tpu_torch.train.trainer import Trainer

    spec = torch.load(path, weights_only=False)
    with torch.backends.mkldnn.flags(enabled=False):
        t = Trainer(EndoDAVOptions().parse([*spec["flags"], "--mesh_shape", f"data={data}"]))
        with_motion(t)
        scalars = t.train_one_batch(shard_batch(spec["batch"], t.mesh))
    out = {"scalars": {k: float(v) for k, v in scalars.items()},
           "state": {f"{c}.{k}": v for c, m in t.mods.items()
                     for k, v in m.state_dict().items()},
           "grads": {f"{c}.{n}": p.grad for c, m in t.mods.items()
                     for n, p in m.named_parameters() if p.grad is not None}}
    if data == 1:
        torch.save(out, f"{path}.d1")
        return
    ref = torch.load(f"{path}.d1", weights_only=False)
    summary = {"scalars": out["scalars"], "grad_keys": sorted(out["grads"]),
               "grads": {k: float((g - ref["grads"][k]).abs().max()) for k, g in
                         out["grads"].items()},
               "state": {k: float((v.float() - ref["state"][k].float()).abs().max())
                         for k, v in out["state"].items()},
               "unlike_rank0": []}
    for k, v in out["state"].items():  # every rank's copy against rank 0's
        mine = v.clone()
        dist.broadcast(v, src=0)
        if not torch.equal(mine, v):
            summary["unlike_rank0"].append(k)
    flags = torch.tensor([len(summary["unlike_rank0"])])
    dist.all_reduce(flags)
    summary["ranks_unlike"] = int(flags)
    if t.mesh.rank == 0:
        torch.save(summary, f"{path}.d{data}")
