"""Process groups, the one-axis mesh, and the placement of batches and weights.

Counterpart of bem_tpu/parallel/mesh.py in PyTorch's idiom: one process is
one rank, and ``torch.distributed`` carries the collectives, outside the
kernels. bem_tpu's ``Mesh`` of devices becomes :class:`Mesh`, the process
group with its axis name and this rank's device. ``shard_batch`` gives this
rank its slice of the leading dimension, ``replicate`` broadcasts rank 0's
weights, and the gradient all-reduce XLA inserts is the trainers' own
(``models/base_model.py``).

The backend follows the device map, decided before ``init_process_group``
(:func:`pick_backend`): NCCL where every rank has a GPU of its own, gloo on
the CPU and where ranks share a card (NCCL refuses two ranks on one GPU).
gloo's support for CUDA tensors differs from collective to collective, and
it copies through the host in any case, so under gloo every collective
here stages a CUDA tensor through pinned host memory explicitly
(:meth:`Mesh.staged`).

Ranks start from a launcher (:func:`init_dist`: torchrun, slurm, or
whichever of the two the environment holds) or from :func:`spawn`, which
the CPU tests and chip_smoke use. A world of one process needs no group:
every collective is then the identity.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import re
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCHERS = ("none", "pytorch", "slurm", "jax")
DEFAULT_PORT = 29500


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the process group (None in a world of one), the axis
    name, this rank's device, its rank, the world's size and the backend."""
    group: Any
    axis: str
    device: torch.device
    rank: int
    size: int
    backend: str

    @property
    def staged(self) -> bool:
        """Collectives copy CUDA tensors through the host (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # ------------------------------------------------------------ collectives
    def _empty(self, shape, dtype) -> torch.Tensor:
        """A buffer the collective writes: pinned host memory when staged."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collective reads it: a pinned host copy when staged."""
        if not self.staged:
            return t
        h = self._empty(t.shape, t.dtype)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return h

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device, non_blocking=True) if self.staged else t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on each), in rank order."""
        if self.size == 1:
            return [t]
        h = self._host(t.contiguous())
        out = [self._empty(h.shape, h.dtype) for _ in range(self.size)]
        dist.all_gather(out, h, group=self.group)
        return [self._back(o, t) for o in out]

    def all_to_all(self, sends: Sequence[torch.Tensor], recv_shapes) -> List[torch.Tensor]:
        """Send ``sends[j]`` to rank j; returns what each rank sent here, in
        rank order, with the shapes ``recv_shapes`` (one
        ``all_to_all_single`` over the flattened pieces: the sizes may differ)."""
        if self.size == 1:
            return [sends[0].reshape(recv_shapes[0])]
        t0 = sends[0]
        flat = self._host(torch.cat([s.reshape(-1) for s in sends]))
        sizes_in = [s.numel() for s in sends]
        sizes_out = [int(np.prod(s)) for s in recv_shapes]
        out = (self._empty(sum(sizes_out), flat.dtype) if self.staged
               else torch.empty(sum(sizes_out), dtype=flat.dtype, device=flat.device))
        dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=self.group)
        out = self._back(out, t0)
        return [p.reshape(s) for p, s in zip(out.split(sizes_out), recv_shapes)]

    def all_reduce_mean(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each tensor of ``ts``, in one all-reduce
        of their flattened fp32 concatenation; each back in its own dtype."""
        ts = list(ts)
        if self.size == 1 or not ts:
            return ts
        flat = self._host(torch.cat([t.detach().reshape(-1).float() for t in ts]))
        dist.all_reduce(flat, group=self.group)
        flat = self._back(flat / self.size, ts[0])
        return [p.reshape(t.shape).to(t.dtype)
                for p, t in zip(flat.split([t.numel() for t in ts]), ts)]

    def broadcast_(self, ts: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor of ``ts`` in place with rank ``src``'s."""
        if self.size == 1:
            return
        for t in ts:
            h = self._host(t.detach())
            dist.broadcast(h, src, group=self.group)
            if self.staged:
                with torch.no_grad():
                    t.copy_(h)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


class BatchSharding(NamedTuple):
    """The leading dimension split over ``axis``: ``shard_batch``'s descriptor."""
    mesh: Mesh
    axis: str


class ReplicatedSharding(NamedTuple):
    """Every rank holds the whole value: ``replicate``'s descriptor."""
    mesh: Mesh


# ---------------------------------------------------------------- the group
def pick_backend(devices: Sequence) -> str:
    """"nccl" where every rank has a CUDA device of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    if devs and all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def first_host(nodelist: str) -> str:
    """The first host of a slurm node list: "node[03-04,07],gpu9" -> "node03"."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None or not m.group(1):
        raise ValueError(f"slurm node list {nodelist!r}: no host")
    if m.group(2) is None:
        return m.group(1)
    return m.group(1) + m.group(2).split(",")[0].split("-")[0]


def _launch_env(launcher: str) -> dict:
    """(rank, world size, local rank, local world size, init method) from the
    launcher's environment; raises where it lacks a variable."""
    env = os.environ
    if launcher == "jax":  # bem_tpu's "detect the cluster"
        if "RANK" in env and "WORLD_SIZE" in env:
            launcher = "pytorch"
        elif "SLURM_PROCID" in env:
            launcher = "slurm"
        else:
            raise RuntimeError("--launcher jax: neither torchrun's (RANK, WORLD_SIZE) nor "
                               "slurm's (SLURM_PROCID) environment is set")
    try:
        if launcher == "pytorch":
            world = int(env["WORLD_SIZE"])
            return dict(rank=int(env["RANK"]), world=world,
                        local_rank=int(env.get("LOCAL_RANK", 0)),
                        local_world=int(env.get("LOCAL_WORLD_SIZE", world)),
                        init_method="env://")
        if launcher == "slurm":
            world = int(env["SLURM_NTASKS"])
            host = first_host(env["SLURM_NODELIST"])
            port = int(env.get("MASTER_PORT", DEFAULT_PORT))
            return dict(rank=int(env["SLURM_PROCID"]), world=world,
                        local_rank=int(env.get("SLURM_LOCALID", 0)),
                        local_world=int(env.get("SLURM_NTASKS_PER_NODE", "1").split("(")[0]),
                        init_method=f"tcp://{host}:{port}")
    except KeyError as e:
        raise RuntimeError(f"--launcher {launcher}: the environment lacks {e.args[0]}") from None
    raise ValueError(f"launcher {launcher!r} is not one of {LAUNCHERS}")


def init_dist(launcher: str, device: str = "cuda") -> Mesh:
    """Start this rank's process group from ``launcher``'s environment
    ("pytorch": torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_*;
    "slurm": SLURM_PROCID / SLURM_NTASKS / SLURM_NODELIST, the first host
    the rendezvous, MASTER_PORT or 29500; "jax": whichever of the two is
    set). ``device`` "cuda" gives each rank card LOCAL_RANK modulo the
    cards present, "cpu" the CPU. Any failure raises: no rank runs alone."""
    e = _launch_env(launcher)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--launcher {launcher} on {device}: no CUDA device")
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i % n) for i in range(e["local_world"])]
        dev = devices[e["local_rank"] % len(devices)]
        torch.cuda.set_device(dev)
    else:
        devices = [torch.device("cpu")] * e["local_world"]
        dev = torch.device("cpu")
    backend = pick_backend(devices)
    print(f"[parallel] rank {e['rank']} of {e['world']} on {dev}: backend {backend} "
          f"({e['local_world']} rank(s) on this host)", flush=True)
    dist.init_process_group(backend, init_method=e["init_method"], rank=e["rank"],
                            world_size=e["world"])
    return make_mesh(device=dev)


# ------------------------------------------------------------------ the mesh
def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """The mesh of the started process group (a world of one without one)
    along ``axis_names[0]`` (bem_tpu's further axes are of size 1 by
    default; the port's mesh has one axis). ``n_devices``, where given, must
    be the world's size. ``device``: this rank's device (the current CUDA
    device where there is a card, else the CPU)."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size, backend = (dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                                      dist.get_backend())
    else:
        group, rank, size, backend = None, 0, 1, "none"
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the world has {size} rank(s)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(group, axis_names[0], torch.device(device), rank, size, backend)


def world_mesh(device) -> Optional[Mesh]:
    """The mesh of the ranks this process is one of: the started process
    group, or one started from torchrun's environment (WORLD_SIZE above 1);
    None for a process on its own. ``device``: this rank's where no group
    has started yet, or on the CPU."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return make_mesh(device=device if device.type == "cpu" else None)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_dist("pytorch", str(device))
    return None


def batch_sharding(mesh: Mesh, axis: str = "data") -> BatchSharding:
    return BatchSharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch, axis: str = "data"):
    """This rank's slice of the leading dimension of every array in
    ``batch`` (a dict / list / tuple tree of tensors or numpy arrays), as
    tensors on the mesh's device; other leaves pass. ``mesh`` may be a
    :class:`BatchSharding`. The leading dimension must divide by the world."""
    if isinstance(mesh, BatchSharding):
        mesh, axis = mesh
    n, r = mesh.size, mesh.rank

    def put(x):
        if isinstance(x, np.ndarray) and x.dtype != object:
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"shard_batch over {axis!r}: leading dimension {x.shape[0]} "
                             f"does not divide by {n} ranks")
        m = x.shape[0] // n
        return x[r * m:(r + 1) * m].to(mesh.device)

    return _map(put, batch)


def replicate(mesh, tree):
    """Rank 0's values everywhere: a module's parameters and buffers are
    overwritten in place (the module is returned), a tree of tensors is
    returned as broadcast copies on the mesh's device. ``mesh`` may be a
    :class:`ReplicatedSharding`."""
    if isinstance(mesh, ReplicatedSharding):
        mesh = mesh.mesh
    if isinstance(tree, torch.nn.Module):
        mesh.broadcast_(list(tree.parameters()) + list(tree.buffers()))
        return tree
    out = _map(lambda x: x.detach().to(mesh.device).clone()
               if isinstance(x, torch.Tensor) else x, tree)
    leaves = []
    _map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else None, out)
    mesh.broadcast_(leaves)
    return out


# ------------------------------------------------------------------ spawning
def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, devices, store, threads, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = pick_backend(devices)
        if rank == 0:
            print(f"[parallel] spawn: {len(devices)} ranks on {[str(d) for d in devices]}: "
                  f"backend {backend}", flush=True)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=len(devices))
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            if dist.is_initialized():  # fn may have ended it to start its own
                dist.destroy_process_group()
        results.put((rank, True, _to_host(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, args=(), devices=None, threads: int = 1,
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks, each a fresh process (the
    spawn start method, never fork after CUDA is up) with its group started
    on a file store in a temporary directory; returns each rank's result in
    rank order, tensors as numpy arrays. ``fn`` and ``args`` must pickle
    (``fn`` by its import path). ``devices``: one per rank (CPU by default);
    the backend follows them (:func:`pick_backend`). ``threads``: torch's
    intra-op threads in each rank. A rank that raises, or a run past
    ``timeout`` seconds, ends every rank and raises here."""
    devices = [str(torch.device(d)) for d in (devices or ["cpu"] * nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"spawn: {len(devices)} devices for {nprocs} ranks")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bem_spawn_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, devices, os.path.join(tmp, "store"), threads, args,
                               results))
             for r in range(nprocs)]
    out, failed = {}, None
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs and failed is None:
            try:
                rank, ok, val = results.get(timeout=timeout)
            except queue.Empty:
                failed = f"no result within {timeout} s"
                break
            if ok:
                out[rank] = val
            else:
                failed = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}): {failed}")
    return [out[r] for r in range(nprocs)]
