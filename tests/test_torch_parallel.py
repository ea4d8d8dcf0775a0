"""The port's parallel/ against bem_tpu's on its 8-device virtual CPU mesh.

The port runs as 4 gloo ranks (``parallel.spawn``, one spawn for the
module, the ranks' side in torch_parallel_workers.py); bem_tpu runs here
on a 4-device mesh of the same axis, the weights converted from the
port's seeded nets (``convert.state_dict_to_flax``).

- ``context_parallel_linear_scan`` on a (2, 4*48, 16) sequence against
  bem_tpu's on a "seq" mesh (its local scans on the "ref" backend, which
  compiles in a third of the "xla" one's time): 1e-5 of max(1, |bem_tpu|).
- ``spatial_apply`` of the "xla" Network (n_feat 8, blocks (1, 1)) on
  H=64 x W=48 against bem_tpu's on a "space" mesh: 2e-5; each rank's row-8
  calls scan L = H*W/4 at each level. Also W=44, whose bottom level's 22
  columns split unevenly over 4 ranks (the chunks padded to the longer),
  and the ConvDown / DeconvUp net (use_pixelshuffle false); the bf16
  stream against the port's unsharded bf16 net (2e-2).
- The mesh's collectives and placements, the backend rule, the slurm
  node list, each launcher's environment, and ``--launcher`` / ``--local_rank``
  through the train and test CLIs' parser (a world of one started for real);
  ``num_gpu`` (the whole batch in one process without a launcher,
  batch_size_per_gpu a rank under one).
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.parallel import make_mesh as jax_mesh
from bem_tpu.parallel.context import context_parallel_linear_scan as jax_context_scan
from bem_tpu.parallel.spatial import spatial_apply as jax_spatial_apply
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.parallel import make_mesh, spatial_apply, spawn
from bem_tpu_torch.parallel import mesh as pmesh
from bem_tpu_torch.utils.options import parse_options

import torch_parallel_workers as workers
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

N = 4
CFG = dict(type="Network", in_channels=3, out_channels=3, n_feat=8, stage=1, num_blocks=(1, 1),
           d_state=(1, 1), ssm_ratio=1, mlp_ratio=2, use_pixelshuffle=True, scan_backend="xla")
CASES = {"w48": (CFG, 48), "w44_uneven": (CFG, 44),
         "conv_down": (dict(CFG, use_pixelshuffle=False), 48)}
H = 64


@pytest.fixture(scope="module")
def ranks():
    rng = np.random.default_rng(0)
    a = rng.random((2, N * 48, 16)).astype(np.float32)
    b = rng.standard_normal((2, N * 48, 16)).astype(np.float32)
    cases = {name: (cfg, i, rng.random((1, H, w, 3)).astype(np.float32))
             for i, (name, (cfg, w)) in enumerate(CASES.items())}
    cases["w48_bf16"] = cases["w48"]
    res = spawn(workers.scan_and_spatial, N, args=(a, b, cases))
    return a, b, cases, res


def test_context_scan_matches_bem_tpu(ranks):
    a, b, _, res = ranks
    want = np.asarray(jax_context_scan(jnp.asarray(a), jnp.asarray(b),
                                       jax_mesh(N, axis_names=("seq",)), axis="seq",
                                       backend="ref"))
    got = np.concatenate([r["scan"] for r in res], -2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_apply_matches_bem_tpu(ranks, name):
    _, _, cases, res = ranks
    cfg, seed, x = cases[name]
    net = build_network(cfg, torch.Generator().manual_seed(seed))
    variables = {"params": state_dict_to_flax(net)}
    want = np.asarray(jax_spatial_apply(jax_build(cfg), variables, jnp.asarray(x),
                                        jax_mesh(N, axis_names=("space",))))
    got = np.concatenate([r[name] for r in res], 1)
    assert got.shape == want.shape == (1, H, x.shape[2], 3)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # row 8 runs on every rank, once a block, on a chunk of H*W/n positions
    # of each level (the longer of the rank's two where the columns split
    # unevenly)
    W = x.shape[2]
    levels = [(8 * 2 ** i, H // 2 ** i, W // 2 ** i) for i in range(2)]
    for r, out in enumerate(res):
        want_shapes = []
        for C, h, w in levels + levels[:1]:  # encoder, bottleneck, decoder
            cols = w // N + (r < w % N)
            want_shapes.append((1, 2, C, max(h * w // N, cols * h)))
        assert sorted(map(tuple, out[name + "_core_shapes"])) == sorted(want_shapes)
        if W % (2 * N) == 0:
            assert {s[-1] for s in want_shapes} == {h * w // N for _, h, w in levels}


def test_spatial_apply_bf16_matches_unsharded(ranks):
    """The bf16 stream row-sharded against the port's unsharded bf16 net:
    the carries join row 8's rounded output in fp32 and round once more,
    within the kernels' bf16 bound, 2e-2 of max(1, |ref|)."""
    _, _, cases, res = ranks
    cfg, seed, x = cases["w48_bf16"]
    net = build_network(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = net(torch.from_numpy(x).to(torch.bfloat16))[-1].float().numpy()
    got = np.concatenate([r["w48_bf16"] for r in res], 1)
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())


def test_mesh_collectives_and_placement(ranks):
    res = ranks[3]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["all_gather"],
                                      np.arange(6.0)[None] + 10 * np.arange(N)[:, None])
        # every rank i sends r + 1 copies of i to rank r
        np.testing.assert_array_equal(out["all_to_all"], np.repeat(np.arange(N), r + 1))
        np.testing.assert_array_equal(out["mean"], np.full((2, 2), (N - 1) / 2))
        np.testing.assert_array_equal(out["shard"],
                                      np.arange(8 * N).reshape(2 * N, 4)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["replicated_module"], np.zeros((2, 3)))
        np.testing.assert_array_equal(out["replicated_tree"], np.zeros(2))


def test_backend_rule_and_node_list():
    assert pmesh.pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pmesh.pick_backend(["cuda:0", "cuda:0"]) == "gloo"  # two ranks share a card
    assert pmesh.pick_backend(["cpu"] * 4) == "gloo"
    assert pmesh.pick_backend(["cuda:0", "cpu"]) == "gloo"
    assert pmesh.first_host("node[03-04,07],gpu9") == "node03"
    assert pmesh.first_host("gpu-a[5,1]") == "gpu-a5"
    assert pmesh.first_host("host1,host2") == "host1"
    assert pmesh.first_host("solo") == "solo"


def _clear_launch_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_LOCALID",
              "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)


def test_launcher_environments(monkeypatch):
    _clear_launch_env(monkeypatch)
    with pytest.raises(RuntimeError, match="neither"):
        pmesh._launch_env("jax")
    with pytest.raises(RuntimeError, match="lacks WORLD_SIZE"):
        pmesh._launch_env("pytorch")
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_NODELIST", "gpu[12-13]")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_NTASKS_PER_NODE", "4(x2)")
    want = dict(rank=5, world=8, local_rank=1, local_world=4, init_method="tcp://gpu12:29500")
    assert pmesh._launch_env("slurm") == want
    assert pmesh._launch_env("jax") == want  # the one environment present
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    want = dict(rank=3, world=4, local_rank=1, local_world=2, init_method="env://")
    assert pmesh._launch_env("pytorch") == want
    assert pmesh._launch_env("jax") == want  # torchrun's first


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("launcher", ["none", "pytorch", "slurm", "jax"])
@pytest.mark.parametrize("is_train", [True, False])
def test_cli_parser_takes_launchers(monkeypatch, tmp_path, launcher, is_train):
    """The train and test CLIs' parser (bem_tpu's four --launcher choices and
    --local_rank): a world of one started from each launcher's environment
    gives rank 0, world size 1 and dist; the seed is manual_seed + rank."""
    _clear_launch_env(monkeypatch)
    port = str(_free_port())
    if launcher in ("pytorch", "jax"):
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", port)):
            monkeypatch.setenv(k, v)
    elif launcher == "slurm":
        for k, v in (("SLURM_PROCID", "0"), ("SLURM_NTASKS", "1"),
                     ("SLURM_NODELIST", "localhost"), ("MASTER_PORT", port)):
            monkeypatch.setenv(k, v)
    opt_file = tmp_path / "o.yml"
    opt_file.write_text("name: par\nmanual_seed: 7\nnum_gpu: auto\nlogger:\n  print_freq: 1\n")
    try:
        opt, args = parse_options(str(tmp_path), is_train, [
            "--opt", str(opt_file), "--launcher", launcher, "--local_rank", "0",
            "--device", "cpu"])
        assert (opt["dist"], opt["rank"], opt["world_size"]) == (launcher != "none", 0, 1)
        assert args.local_rank == 0 and opt["num_gpu"] == 1 and opt["device"] == "cpu"
        assert torch.distributed.is_initialized() == (launcher != "none")
        if launcher != "none":
            assert torch.distributed.get_backend() == "gloo"
            assert make_mesh().size == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_launcher_without_environment_raises(monkeypatch, tmp_path):
    """No rank carries on alone where a launcher was asked for."""
    _clear_launch_env(monkeypatch)
    opt_file = tmp_path / "o.yml"
    opt_file.write_text("name: par\nmanual_seed: 7\n")
    for launcher in ("pytorch", "slurm", "jax"):
        with pytest.raises(RuntimeError, match=f"--launcher {launcher}"):
            parse_options(str(tmp_path), True, ["--opt", str(opt_file), "--launcher", launcher,
                                                "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_spatial_apply_refuses_what_it_cannot_shard():
    mesh = make_mesh()  # a world of one
    x = torch.rand(1, 64, 48, 3)
    with pytest.raises(AssertionError, match="scan_backend='xla'"):
        spatial_apply(build_network(dict(CFG, scan_backend=None)), x, mesh)
    with pytest.raises(NotImplementedError, match="SAM"):
        spatial_apply(build_network(dict(CFG, sam=True)), x, mesh)
    with pytest.raises(ValueError, match="n \\* 2\\^levels"):
        spatial_apply(build_network(CFG), x[:, :5], mesh)
    # a world of one is the unsharded forward (the convs' zero rows are
    # concatenated rather than padded: another summation path)
    net = build_network(CFG, torch.Generator().manual_seed(3))
    with torch.no_grad():
        np.testing.assert_allclose(spatial_apply(net, x, mesh).numpy(), net(x)[-1].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_gpu,dist,want", [(3, False, 6), (3, True, 2), (1, False, 2)])
def test_train_batch_per_process(num_gpu, dist, want):
    """Without a launcher num_gpu > 1 runs batch_size_per_gpu x num_gpu in
    one process, as bem_tpu's build_dataloader; a rank under dist takes
    batch_size_per_gpu from its sampler's slice."""
    from bem_tpu_torch.data import build_dataloader

    loader = build_dataloader(list(range(12)), {"phase": "train", "batch_size_per_gpu": 2},
                              num_gpu=num_gpu, dist=dist)
    assert loader.batch_size == want


def test_num_gpu_in_the_options(tmp_path):
    opt_file = tmp_path / "o.yml"
    opt_file.write_text("name: par\nmanual_seed: 7\nnum_gpu: 4\n")
    opt, _ = parse_options(str(tmp_path), True, ["--opt", str(opt_file), "--device", "cpu"])
    assert opt["num_gpu"] == 4 and not opt["dist"]


def test_spawn_ends_every_rank_when_one_fails():
    """A rank that raises: the parent ends the rank still waiting on it and
    raises with the failing rank's traceback, well inside the timeout."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 gives up"):
        spawn(workers.fail_on_rank_1, 2, timeout=120)
    assert time.perf_counter() - t0 < 60
