"""Process groups for the port's parallel paths, on `torch.distributed`.

Port of `endodav_tpu/parallel/__init__.py`.  JAX runs one process for all
devices and shards arrays over a `Mesh`; PyTorch runs one process a rank.
So a mesh here is a list of devices, one rank each, and the process
groups of its axes:

* `parse_mesh_shape` keeps JAX's rules: ``'data=N'``, ``'model=N'`` only
  for serving (``allow_model``), anything else a ValueError.
* `build_mesh` is the 1-D ``data`` mesh over the first N devices (the
  visible cards, or the ``devices`` given).  N above their number raises,
  or is clamped to it with ``clamp`` (training, JAX `trainer.py:211`).
  Inside a world of N ranks its group is the world; a size-1 mesh outside
  any world has no group, and every collective below is then the identity.
* `replicated` broadcasts a module's parameters and buffers from rank 0;
  `data_sharding` is a rank's slice of a leading axis and `shard_batch`
  applies it to every array of a batch.
* `launch` runs a function as N ranks: under ``torchrun`` it joins the
  environment's group; otherwise one rank runs in this process (N = 1) or
  N ranks start with `torch.multiprocessing` (start method ``spawn``),
  so JAX's command lines (``scripts/train_dp.sh``) run unchanged.  Rank 0
  alone prints: the others' standard output goes to ``os.devnull``.

The backend is chosen and printed once a rank: ``nccl`` when each rank has
a CUDA device of its own, ``gloo`` on the CPU and where several ranks
share a card (gloo takes only ``broadcast`` and ``all_reduce`` on CUDA
tensors, so every gather here is an ``all_reduce`` into a zeroed buffer).
An init failure raises; nothing retries on another backend.  Every group
carries a timeout (`DIST_TIMEOUT`, 600 s), so a rank that dies does not
leave the others waiting for ever.

`global_sum` and `gather_rows` are the autograd functions of data-parallel
training.  Their backward is an ``all_reduce`` of the incoming gradient
(a gather's: then the rank's own rows), and each rank backpropagates the
replicated loss divided by the data size (`loss_share`): the shares of
every rank sum to the gradient of the global loss, so a data=N step's
gradients are the data=1 step's once `sum_gradients` adds them up.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["Mesh", "build_mesh", "parse_mesh_shape", "replicated", "data_sharding",
           "shard_batch", "visible_devices", "choose_backend", "launch", "world_devices",
           "is_main", "barrier", "all_gather_rows", "global_sum", "gather_rows",
           "data_parallel", "data_mesh", "loss_share", "sum_gradients", "check_devices",
           "all_reduce_sum", "run_cli", "global_mean", "global_max"]

_WORLD_DEVICES: list[torch.device] | None = None  # one device a rank, set at init
_DATA: "Mesh | None" = None                       # the data mesh of a training step
# a collective that waits longer fails: no path of the port waits near it
DIST_TIMEOUT = datetime.timedelta(seconds=600)


def parse_mesh_shape(spec: str | None, allow_model: bool = False) -> int | None:
    """``--mesh_shape`` / ``--serve_mesh``: '' or None -> None (the caller
    decides), 'data=N' -> N, 'model=N' -> None with ``allow_model`` (the
    tensor-parallel trunk is built by `parallel.tp`), anything else raises
    (a training ``model=N`` is a loud error, as in JAX)."""
    if not spec:
        return None
    if spec.startswith("data="):
        return int(spec.split("=", 1)[1])
    if allow_model and spec.startswith("model="):
        return None
    expected = "'data=N' or 'model=N'" if allow_model else "'data=N'"
    raise ValueError(f"mesh spec must be {expected}, got {spec!r}")


def visible_devices(cpu: bool = False) -> list[torch.device]:
    """The CUDA cards this process sees, one rank each; the CPU (one device,
    as a JAX host without virtual devices) with ``cpu`` or without a card."""
    if cpu or not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def world_devices() -> list[torch.device]:
    """The devices of the current world, one a rank: those `launch` was
    given, ``cuda:(rank % cards)`` under ``torchrun``, else the visible ones."""
    if _WORLD_DEVICES is not None and dist.is_initialized():
        return list(_WORLD_DEVICES)
    return visible_devices()


def check_devices(n: int, devices, what: str = "mesh") -> list[torch.device]:
    """``devices[:n]``, raising JAX's error when fewer are given."""
    devs = [torch.device(d) for d in devices]
    if n < 1:
        raise ValueError(f"{what} needs N >= 1, got {n}")
    if n > len(devs):
        raise ValueError(f"{what} wants {n} devices, only {len(devs)} visible")
    return devs[:n]


def choose_backend(devices) -> str:
    """``nccl`` when every rank has a CUDA device of its own, ``gloo`` when
    all are the CPU or some ranks share a card."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's devices must all be CUDA or all the CPU, got {devs}")
    indices = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(indices)) == len(indices) else "gloo"


class Mesh:
    """Devices on named axes, one rank each, and this rank's groups.

    ``shape`` maps axis names to sizes in row-major order of the ranks
    (``{"data": d, "model": g}``: rank = data index * g + model index).
    Built inside a world of exactly ``len(devices)`` ranks, it makes one
    process group an axis line (every rank makes all of them, in the same
    order, as `torch.distributed.new_group` requires); a size-1 mesh
    outside any world has none."""

    def __init__(self, devices, shape: dict[str, int]):
        self.devices = [torch.device(d) for d in devices]
        self.shape = dict(shape)
        size = 1
        for s in self.shape.values():
            size *= s
        if size != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold {len(self.devices)} devices")
        self.size = size
        self._groups: dict[str, object] = {}
        if not dist.is_initialized():
            if size != 1:
                raise RuntimeError(
                    f"a mesh of {size} devices needs {size} ranks: run under "
                    "endodav_tpu_torch.parallel.launch or torchrun")
            self.rank = 0
            self.coords = {a: 0 for a in self.shape}
            return
        world = dist.get_world_size()
        if world != size:
            raise ValueError(f"a mesh of {size} devices in a world of {world} ranks")
        self.rank = dist.get_rank()
        axes = list(self.shape)
        sizes = [self.shape[a] for a in axes]
        coords, r = [], self.rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(axes, reversed(coords)))
        for ai, axis in enumerate(axes):
            if sizes[ai] == 1:
                continue
            if sizes[ai] == size:
                self._groups[axis] = dist.group.WORLD
                continue
            stride = 1
            for s in sizes[ai + 1:]:
                stride *= s
            # every line of this axis: the ranks that differ in this coordinate only
            for base in range(size):
                if (base // stride) % sizes[ai]:
                    continue
                ranks = [base + k * stride for k in range(sizes[ai])]
                group = dist.new_group(ranks, timeout=DIST_TIMEOUT)
                if self.rank in ranks:
                    self._groups[axis] = group

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for a
        size-1 mesh outside any world)."""
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices]})"


def build_mesh(spec: str | None = None, devices=None, default_all: bool = True,
               clamp: bool = False, allow_model: bool = False) -> Mesh | None:
    """The 1-D ``data`` mesh (JAX `build_mesh`): 'data=N' takes the first N
    of ``devices`` (default: `world_devices`); '' or None takes all of them
    when ``default_all``, else returns None (serving without
    ``--serve_mesh``); 'model=N' with ``allow_model`` -> None (the
    tensor-parallel mesh is `parallel.tp.build_tp_mesh`).  N above the
    devices' number raises, unless ``clamp`` shrinks it."""
    n = parse_mesh_shape(spec, allow_model=allow_model)
    if n is None and not default_all:
        return None
    devs = [torch.device(d) for d in (devices if devices is not None else world_devices())]
    if n is not None:
        if n > len(devs):
            if not clamp:
                raise ValueError(f"mesh wants {n} devices, only {len(devs)} visible")
            print(f"[parallel] mesh wants {n} devices, only {len(devs)} visible: "
                  f"clamped to data={len(devs)}")
            n = len(devs)
        devs = devs[:n]
    return Mesh(devs, {"data": len(devs)})


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (no group: ``t`` as it is); bf16
    and f16 are added in f32 and rounded once."""
    if _group_size(group) == 1:
        return t
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=group)
        t.copy_(wide)
        return t
    dist.all_reduce(t, group=group)
    return t


def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the mesh's
    rank 0: each rank holds the same copy (JAX's replicated sharding)."""
    group = mesh.group("data") if "data" in mesh.shape else None
    if _group_size(group) > 1:
        src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD else 0
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=group)
    return module


def data_sharding(n: int, mesh: Mesh | None) -> slice:
    """This rank's slice of a leading axis of ``n`` over the ``data`` axis;
    ``n`` not divided by the axis raises, as JAX's `device_put` does."""
    size = 1 if mesh is None else mesh.axis_size("data")
    if n % size:
        raise ValueError(f"the batch of {n} is not divisible by the data axis of {size}")
    per = n // size
    r = 0 if mesh is None else mesh.axis_rank("data")
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """Each array of a batch cut to this rank's slice of its leading axis."""
    out = {}
    for k, v in batch.items():
        out[k] = v[data_sharding(len(v), mesh)] if hasattr(v, "shape") and v.ndim else v
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` (equal shapes) along dim 0 over
    ``group``, as an ``all_reduce`` into a zeroed buffer (gloo's CUDA
    collectives have no ``all_gather``); no gradient."""
    size = _group_size(group)
    if size == 1:
        return x
    rank = dist.get_rank(group)
    buf = torch.zeros((size, *x.shape), dtype=x.dtype, device=x.device)
    buf[rank] = x
    all_reduce_sum(buf, group)
    return buf.reshape(size * x.shape[0], *x.shape[1:])


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        full = all_reduce_sum(grad.contiguous().clone(), ctx.group)
        return full[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Within this block `global_sum`, `gather_rows` and `loss_share` work
    over ``mesh``'s ``data`` axis (no mesh, or a size-1 one: the identity)."""
    global _DATA
    prev, _DATA = _DATA, mesh
    try:
        yield mesh
    finally:
        _DATA = prev


def data_mesh() -> Mesh | None:
    """The data mesh of the enclosing `data_parallel` block, if larger than 1."""
    return _DATA if _DATA is not None and _DATA.axis_size("data") > 1 else None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (differentiable; see the module
    docstring for the backward)."""
    mesh = data_mesh()
    if mesh is None:
        return x
    return _GlobalSum.apply(x, mesh.group("data"))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along dim 0, in rank order
    (differentiable)."""
    mesh = data_mesh()
    if mesh is None:
        return x
    return _GatherRows.apply(x.contiguous(), mesh.group("data"))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the whole batch of the data ranks (equal
    shapes a rank); ``x.mean()`` outside a data mesh."""
    mesh = data_mesh()
    if mesh is None:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * mesh.axis_size("data"))


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest value of ``x`` over the data ranks, without gradient."""
    m = x.max().detach()
    mesh = data_mesh()
    if mesh is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group("data"))
    return m


def loss_share(loss: torch.Tensor) -> torch.Tensor:
    """What this rank backpropagates of a replicated loss: loss / data size."""
    mesh = data_mesh()
    return loss if mesh is None else loss / mesh.axis_size("data")


def sum_gradients(params, mesh: Mesh | None) -> None:
    """Add every rank's gradients up (one flat ``all_reduce``): with
    `loss_share` the result is the gradient of the global loss."""
    if mesh is None or mesh.axis_size("data") == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=mesh.group("data"))
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def is_main() -> bool:
    """Rank 0, or no world: the rank that prints and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ------------------------------------------------------------------ launch

def _init(rank: int, devices, init_method: str) -> None:
    global _WORLD_DEVICES
    devs = [torch.device(d) for d in devices]
    backend = choose_backend(devs)
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, init_method=init_method, rank=rank, world_size=len(devs),
                  timeout=DIST_TIMEOUT)
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    _WORLD_DEVICES = devs
    print(f"[parallel] backend={backend} world={len(devs)} rank={rank} device={dev}")


def _rank_entry(rank: int, fn, args, devices, init_method: str):
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    _init(rank, devices, init_method)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _prebuild(devices) -> None:
    """Build the CUDA kernels in this process first, so that the ranks load
    them and none races another's nvcc."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from endodav_tpu_torch.kernels import _build

        _build.compile_library()


def launch(fn, args: tuple = (), n: int = 1, devices=None, timeout: float | None = None):
    """Run ``fn(*args)`` as ``n`` ranks on ``devices[:n]`` (default: the
    visible cards), and return rank 0's result in this process when it ran
    here (N = 1, or ``torchrun``).

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) this process is
    one rank of the environment's group, on ``cuda:(rank % cards)``, and
    the world must hold ``n`` ranks.  Otherwise N = 1 runs here, in a world
    of one, and N > 1 spawns N processes; a rank's exception fails the call
    and ends the others.  ``timeout`` (seconds) ends spawned ranks that run
    longer, and raises TimeoutError."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != n:
            raise ValueError(f"the flags ask for {n} ranks, torchrun started {world}")
        if devices is None:
            count = torch.cuda.device_count()
            devs = ([torch.device("cuda", r % count) for r in range(world)] if count
                    else [torch.device("cpu")] * world)
        else:
            devs = check_devices(n, devices)
        if rank != 0:
            sys.stdout = open(os.devnull, "w")
        _init(rank, devs, "env://")
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    devs = check_devices(n, devices if devices is not None else visible_devices())
    # a file rendezvous in a fresh directory: concurrent launches never meet
    store = tempfile.mkdtemp(prefix="endodav_dist_")
    method = f"file://{os.path.join(store, 'rendezvous')}"
    _prebuild(devs)
    try:
        if n == 1:
            _init(0, devs, method)
            try:
                return fn(*args)
            finally:
                dist.destroy_process_group()
        import torch.multiprocessing as mp

        ctx = mp.start_processes(_rank_entry, args=(fn, args, devs, method), nprocs=n,
                                 join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} ran longer "
                                   f"than {timeout} s")
        return None
    finally:
        for name in os.listdir(store):
            os.unlink(os.path.join(store, name))
        os.rmdir(store)


def _under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def run_cli(fn, opt, training: bool):
    """Run a CLI's ``fn(opt)`` as the ranks its flags ask for.

    Training (``--mesh_shape``): 'data=N', clamped to the visible cards as
    JAX's trainer clamps; '' takes them all; one rank and no flag runs
    plainly in this process.  Serving (``--serve_mesh``): 'data=N' or
    'model=N', more than the visible cards raising JAX's errors; no flag
    runs plainly.  Under ``torchrun`` the world's ranks are used."""
    spec = ((opt.mesh_shape if training else opt.serve_mesh) or "")
    devs = visible_devices(cpu=getattr(opt, "no_cuda", False))
    torchrun = _under_torchrun()
    if training:
        n = parse_mesh_shape(spec)
        if n is None:
            n = int(os.environ["WORLD_SIZE"]) if torchrun else len(devs)
        elif n > len(devs) and not torchrun:
            print(f"[parallel] mesh wants {n} devices, only {len(devs)} visible: "
                  f"clamped to data={len(devs)}")
            n = len(devs)
        if n == 1 and not spec and not torchrun:
            return fn(opt)
    else:
        if not spec:
            return fn(opt)
        is_model = spec.startswith("model=")
        n = int(spec.split("=", 1)[1]) if is_model else parse_mesh_shape(spec, allow_model=True)
        if not torchrun:
            check_devices(n, devs, "tensor-parallel mesh" if is_model else "mesh")
    return launch(fn, (opt,), n, None if torchrun else devs)
