"""Full-HD two-stage inference speed test (counterpart of
bem_tpu/enhancement/speed_test.py; reference: Enhancement/speed_test.py).

    python -m bem_tpu_torch.enhancement.speed_test --opt CG.yml --cond_opt IE.yml \\
        [--weights cg.msgpack] [--cond_weights ie.msgpack] [--input_size 2048]
        [--repeat 100] [--speedup] [--dtype bfloat16|float32] [--device cuda]

The reference's protocol (speed_test.py:83-117): a seeded S x S input
(``default_rng(0)``) and its bilinear S/16 reduction, the Bayesian CG
built from ``--opt`` and the IE from ``--cond_opt`` (seeded, or loaded
from bem_tpu's ``.msgpack`` files), then ``repeat`` two-stage forwards in
sequence, each with its own weight sample of the CG (:func:`sequential`),
or, with ``--speedup``, ``repeat`` weight samples of the CG, the mock score
mean(cond^2), the argmin's x16 upsample and one IE forward
(:func:`speedup`). One untimed run comes first (bem_tpu's compile; here
the kernels' build and cuDNN's plans); the timed run prints ``running
time: X sec`` with the device synchronised before each clock read, then
the card's peak memory. bem_tpu vmaps the ``repeat`` CG forwards; the port
runs them one after another, as its eval CLI does.

It runs on the card (``--device cuda``, the default) through the port's
kernels, or on the CPU through their plain versions when asked (use a
small ``--input_size`` there). ``--spatial_shard N`` shards the image rows
over the N ranks of a started process group (``torchrun --nproc_per_node N
-m bem_tpu_torch.enhancement.speed_test ... --spatial_shard N``; any other
world raises): both nets take bem_tpu's "xla" route, as bem_tpu forces
it, and both stages run through ``parallel.spatial_apply`` on each rank's
band of rows (the condition's x16 upsample on ``parallel.upsample_rows``,
the speedup's scores averaged over the ranks); rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.func import functional_call

from ..archs import build_network
from ..convert import load_flax_params
from ..nn.layers import sample_bayes
from ..ops.resize import resize_bilinear
from ..parallel.mesh import make_mesh, world_mesh
from ..parallel.spatial import spatial_apply, upsample_rows
from ..utils.checkpoint import load_params
from ..utils.options import parse

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _cg(net, x_down, i, gen, eps, mesh=None):
    """The CG's condition (1, h, w, 3) under weight sample i: drawn from
    ``gen``, or ``eps[i]`` (see ``sample_bayes``); with ``mesh``, x_down
    and the condition are this rank's band of rows."""
    sample = sample_bayes(net, gen=None if eps is not None else gen,
                          eps=None if eps is None else eps[i])
    if mesh is not None:
        return spatial_apply(net, x_down, mesh, params=sample)
    return functional_call(net, sample, (x_down,))[-1]


def _ie(cond_net, x, cond, scale, mesh=None):
    if mesh is not None:
        up = upsample_rows(cond, scale, mesh).to(x.dtype)
        return spatial_apply(cond_net, torch.cat([x, up], dim=-1), mesh)
    up = resize_bilinear(cond, (cond.shape[1] * scale, cond.shape[2] * scale)).to(x.dtype)
    return cond_net(torch.cat([x, up], dim=-1))[-1]


@torch.inference_mode()
def sequential(net, cond_net, x, x_down, scale: int, repeat: int, gen=None, eps=None,
               mesh=None):
    """``repeat`` two-stage forwards, each with its own CG weight sample and a
    host read of the IE output's sum, as bem_tpu's loop reads it (with
    ``mesh``, of this rank's band). Returns (the sums, the last IE output)."""
    sums, pred = [], None
    for i in range(repeat):
        pred = _ie(cond_net, x, _cg(net, x_down, i, gen, eps, mesh), scale, mesh)
        sums.append(float(pred.float().sum()))
    return sums, pred


@torch.inference_mode()
def speedup(net, cond_net, x, x_down, scale: int, repeat: int, gen=None, eps=None,
            mesh=None):
    """``repeat`` CG weight samples, the mock score mean(cond^2) of each, and
    one IE forward on the lowest-scoring condition (speed_test.py:99-104;
    with ``mesh`` the bands' means averaged over the ranks, each band the
    same size). Returns (the pick, the scores, the IE output)."""
    conds = torch.cat([_cg(net, x_down, i, gen, eps, mesh) for i in range(repeat)])
    scores = conds.float().square().mean(dim=(1, 2, 3))
    if mesh is not None:
        scores = mesh.all_reduce_mean([scores])[0]
    best = int(torch.argmin(scores))
    return best, scores, _ie(cond_net, x, conds[best:best + 1], scale, mesh)


def build_parser():
    p = argparse.ArgumentParser(description="two-stage inference speed test")
    p.add_argument("--opt", required=True, help="Stage-I (CG) YAML")
    p.add_argument("--cond_opt", required=True, help="Stage-II (IE) YAML")
    p.add_argument("--weights", default="")
    p.add_argument("--cond_weights", default="")
    p.add_argument("--input_size", default=2048, type=int)
    p.add_argument("--repeat", default=100, type=int)
    p.add_argument("--speedup", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--spatial_shard", default=0, type=int,
                   help="image rows sharded over the N ranks of the process group (forces "
                        "scan_backend=xla; parallel/spatial.py). 0 = one device.")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the port's kernels) or cpu (their plain versions)")
    return p


def build_nets(args, device):
    """(CG, IE, scale): the Bayesian CG from ``--opt`` (seed 0) and the IE
    from ``--cond_opt`` (seed 1), each loaded from its weights where given;
    both on bem_tpu's "xla" route under ``--spatial_shard``."""
    opt = parse(args.opt, is_train=False)
    cond_opt = parse(args.cond_opt, is_train=False)
    scale = opt["condition"].get("scale_down", 16)
    xla = {"scan_backend": "xla"} if args.spatial_shard else {}
    net = build_network(dict(opt["network_g"], bayesian=True, **xla),
                        torch.Generator().manual_seed(0))
    cond_net = build_network(dict(cond_opt["network_g"], **xla), torch.Generator().manual_seed(1))
    for n, path in ((net, args.weights), (cond_net, args.cond_weights)):
        if path:
            load_flax_params(n, load_params(path, "params"))
    return net.to(device).eval(), cond_net.to(device).eval(), scale


def inputs(size: int, scale: int, dtype, device):
    """The seeded (1, S, S, 3) input and its bilinear S/scale reduction
    (jax.image.resize's "linear": antialiased where it shrinks), computed in
    fp32 and rounded once to ``dtype``."""
    x = torch.from_numpy(np.random.default_rng(0).random((1, size, size, 3))).to(device, dtype)
    sc = size // scale
    return x, resize_bilinear(x.float(), (sc, sc), antialias=True).to(dtype)


def _shard_mesh(n: int, device):
    """The mesh of the N ranks ``--spatial_shard N`` runs on; raises where
    the world has another size."""
    mesh = world_mesh(device) or make_mesh(device=device)
    if mesh.size != n:
        raise ValueError(f"--spatial_shard {n} needs a world of {n} ranks (torchrun "
                         f"--nproc_per_node {n} ... --spatial_shard {n}); this one has "
                         f"{mesh.size}")
    return mesh


def main(args_list=None):
    args = build_parser().parse_args(args_list)
    device = torch.device(args.device)
    mesh = _shard_mesh(args.spatial_shard, device) if args.spatial_shard else None
    if mesh is not None:
        device = mesh.device
    cuda = device.type == "cuda"
    net, cond_net, scale = build_nets(args, device)
    x, x_down = inputs(args.input_size, scale, DTYPES[args.dtype], device)
    if mesh is not None:  # this rank's band of rows of both inputs
        h, hd = x.shape[1] // mesh.size, x_down.shape[1] // mesh.size
        x = x[:, mesh.rank * h:(mesh.rank + 1) * h].contiguous()
        x_down = x_down[:, mesh.rank * hd:(mesh.rank + 1) * hd].contiguous()
    gen = torch.Generator(device=device).manual_seed(0)

    def run(repeat):
        body = speedup if args.speedup else sequential
        body(net, cond_net, x, x_down, scale, repeat, gen, mesh=mesh)
        if cuda:
            torch.cuda.synchronize(device)
        if mesh is not None:
            mesh.barrier()

    run(args.repeat if args.speedup else 1)  # untimed: the kernels' build, first launches
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    run(args.repeat)
    if mesh is not None and mesh.rank:
        return
    print(f"running time: {time.perf_counter() - t0:.4f} sec")
    if cuda:
        print(f"peak memory: {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    main()
