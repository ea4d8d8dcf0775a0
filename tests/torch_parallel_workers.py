"""The ranks' side of the port's multi-process CPU tests
(test_torch_parallel*.py, test_torch_speed_test.py): functions that
``bem_tpu_torch.parallel.spawn`` runs in fresh processes, one a rank. The
module imports no jax, so each rank starts on torch alone; the tests hold
what the ranks return against bem_tpu in the test process."""

import contextlib
import copy
import io

import numpy as np
import torch

from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import build_model
from bem_tpu_torch.parallel import context_parallel_linear_scan, shard_batch, spatial_apply
from bem_tpu_torch.parallel import mesh as pmesh
from bem_tpu_torch.parallel import spatial as pspatial


def _rows(x, mesh, axis=1):
    n = x.shape[axis] // mesh.size
    return np.take(x, range(mesh.rank * n, (mesh.rank + 1) * n), axis=axis)


def scan_and_spatial(mesh, a, b, cases):
    """The context scan of this rank's chunk of (a, b), and spatial_apply
    of each case's net (cfg, seed) on this rank's band of x (bf16 where the
    case's name ends so), with the
    sequence lengths the rank's row-8 calls saw; then the collectives and
    placements of mesh.py on small tensors."""
    out = {"scan": context_parallel_linear_scan(torch.from_numpy(_rows(a, mesh, -2)),
                                                torch.from_numpy(_rows(b, mesh, -2)), mesh)}
    seen = []
    core = pspatial.ss2d_dir_fused

    def recording(xs2, *args, **kw):
        seen.append(tuple(xs2.shape))
        return core(xs2, *args, **kw)

    pspatial.ss2d_dir_fused = recording
    try:
        for name, (cfg, seed, x) in cases.items():
            net = build_network(cfg, torch.Generator().manual_seed(seed)).eval()
            seen.clear()
            band = torch.from_numpy(_rows(x, mesh))
            if name.endswith("_bf16"):  # the bf16 stream
                band = band.to(torch.bfloat16)
            out[name] = spatial_apply(net, band, mesh).float()
            out[name + "_core_shapes"] = list(seen)
    finally:
        pspatial.ss2d_dir_fused = core
    r, n = mesh.rank, mesh.size
    t = torch.arange(6.0) + 10 * r
    out["all_gather"] = torch.stack(mesh.all_gather(t))
    got = mesh.all_to_all([torch.full((j + 1,), float(r)) for j in range(n)],
                          [(r + 1,)] * n)
    out["all_to_all"] = torch.cat(got)
    out["mean"] = mesh.all_reduce_mean([torch.tensor([float(r)]), torch.ones(2, 2) * r])[1]
    out["shard"] = shard_batch(pmesh.batch_sharding(mesh), {"x": np.arange(8 * n).reshape(
        2 * n, 4), "tag": "keep"})["x"]
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r))
    pmesh.replicate(mesh, lin)
    out["replicated_module"] = lin.weight.detach()
    out["replicated_tree"] = pmesh.replicate(pmesh.replicated_sharding(mesh),
                                             {"w": torch.full((2,), float(r))})["w"]
    return out


def train_steps(mesh, opts, batch, eps, mixed_opt, mixed_batch, cli):
    """One step of each trainer under dist on this rank's slice of the
    global batch: (IE params, CG params, the mixup-and-noise IE's params
    and logs), each params tree in flax's layout; then the train CLI under
    ``--launcher pytorch`` (``cli``: root, options file, master port)."""
    out = {}
    for key, opt, b, kw in (("ie", opts["ImageEnhancer"], batch, {}),
                            ("cg", opts["ConditionGenerator"], batch, {"eps": eps}),
                            ("mixed", mixed_opt, mixed_batch, {})):
        opt = dict(copy.deepcopy(opt), dist=True, rank=mesh.rank, world_size=mesh.size)
        net_opt = dict(opt["network_g"])
        if opt["model_type"] == "ConditionGenerator":
            net_opt.update(bayesian=True, sigma_init=0.05)
        net = build_network(net_opt, torch.Generator().manual_seed(0))
        model = build_model(opt, device="cpu", net=net)
        logs = model.train_step(shard_batch(mesh, b), **kw)
        out[key] = state_dict_to_flax(model.net)
        out[key + "_logs"] = {k: float(v) for k, v in logs.items()}
    out.update(_train_cli(mesh, *cli))
    return out


def _train_cli(mesh, root, yml, port):
    """The train CLI as torchrun starts it: this rank's group ends, the
    launcher's environment is set, and ``--launcher pytorch`` starts it
    anew from there."""
    import os

    import torch.distributed as dist

    from bem_tpu_torch.train import train_pipeline

    rank, size = mesh.rank, mesh.size
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    model = train_pipeline(root, ["--opt", yml, "--device", "cpu", "--launcher", "pytorch",
                                  "--force_yml", "train:total_iter=2"])
    return {"cli_step": model.step, "cli_params": state_dict_to_flax(model.net),
            "cli_rank": model.opt["rank"], "cli_world": model.opt["world_size"]}


def eval_k(mesh, cfgs, K, img, cond, tmean, eps, noise_level, noise, main_args):
    """make_k_pipeline sharded over the ranks: its K candidates with every
    draw from a generator ("drawn"), then with the weight noise ``eps`` and
    the condition noise ``noise`` injected ("injected"); then the eval
    CLI's main (rank 0's return; the others' are None) and what it printed."""
    from bem_tpu_torch.enhancement import eval as port_eval

    cg = build_network(cfgs[0], torch.Generator().manual_seed(0)).eval()
    ie = build_network(cfgs[1], torch.Generator().manual_seed(1)).eval()
    pk = port_eval.make_k_pipeline(cg, ie, K=K, P=2, cond_type="mean",
                                   noise_level=noise_level, mesh=mesh)
    args = (torch.from_numpy(img), torch.from_numpy(cond), torch.from_numpy(tmean))
    out = {"drawn": pk(torch.Generator().manual_seed(5), *args, use_gt_mean=False,
                       stochastic=True),
           "injected": pk(None, *args, use_gt_mean=False, stochastic=True, eps=eps,
                          noise=torch.from_numpy(noise))}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out["main"] = port_eval.main(main_args)
    out["log"] = log.getvalue()
    return out


def speed_test_run(mesh, args, check_args, eps):
    """The speed test's main under --spatial_shard (its printed lines), and
    its sequential body on this rank's band with injected CG samples."""
    from bem_tpu_torch.enhancement import speed_test

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        speed_test.main(args)
    a = speed_test.build_parser().parse_args(check_args)
    net, cond_net, scale = speed_test.build_nets(a, "cpu")
    x, x_down = speed_test.inputs(a.input_size, scale, torch.float32, "cpu")
    _, pred = speed_test.sequential(net, cond_net, torch.from_numpy(_rows(x.numpy(), mesh)),
                                    torch.from_numpy(_rows(x_down.numpy(), mesh)), scale, 1,
                                    eps=eps, mesh=mesh)
    return {"log": log.getvalue(), "pred": pred}


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits at a barrier rank 1 never reaches."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    mesh.barrier()
