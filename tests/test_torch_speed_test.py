"""The speed-test CLI (``enhancement/speed_test.py``) against bem_tpu.

Both bodies, :func:`sequential` and :func:`speedup`, run the port's nets
(a Bayesian CG and an IE, n_feat 8, blocks (1,1,1)) on the seeded 128x128
input and its /16 reduction, fp32, with K injected weight samples of the
CG (torch cannot draw ``jax.random``'s). bem_tpu composes the same steps
from its own pieces: its ``Network`` on the carried weights (the CG on
each sample's weights, as ``state_dict_to_flax`` gives them),
``resize_bilinear`` for the reduction and the x16 upsample, the mock score
and argmin of bem_tpu/enhancement/speed_test.py:95-104. Held within 2e-5:
the reduction, every IE output sum (relative), the IE outputs and the
scores (of max(1, |ref|)), and the same pick. Then ``main`` in both modes
on the CPU (the printed line), and ``--spatial_shard 2``: it raises in a
world of one, and on 2 gloo ranks prints the running time, its IE output
(each rank's band through ``parallel.spatial_apply``) within 2e-5 of
bem_tpu's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.ops.resize import resize_bilinear as jax_resize
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.enhancement import speed_test
from bem_tpu_torch.nn import sample_bayes
from bem_tpu_torch.parallel import spawn

import torch_parallel_workers as workers
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

TOL = 2e-5
S, SCALE, K = 128, 16, 3
NET = dict(type="Network", out_channels=3, n_feat=8, num_blocks=(1, 1, 1), d_state=1,
           ssm_ratio=1, mlp_ratio=2, mlp_type="gdmlp", use_pixelshuffle=True)
CG, IE = dict(NET, in_channels=3, bayesian=True), dict(NET, in_channels=6)


@pytest.fixture(scope="module")
def setup():
    net = build_network(CG, torch.Generator().manual_seed(0)).eval()
    cond_net = build_network(IE, torch.Generator().manual_seed(1)).eval()
    x, x_down = speed_test.inputs(S, SCALE, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(5)
    eps = [{k: torch.randn(p.shape, generator=gen) for k, p in net.named_parameters()
            if k.rpartition(".")[2].startswith("mu_")} for _ in range(K)]
    # bem_tpu: the CG on each sample's weights, the IE on its own
    jcg, jie = jax_build(dict(CG, scan_backend="xla")), jax_build(dict(IE, scan_backend="xla"))
    cg_fn = jax.jit(lambda p, x: jcg.apply({"params": p}, x)[-1])
    ie_fn = jax.jit(lambda p, x: jie.apply({"params": p}, x)[-1])
    ie_params = state_dict_to_flax(cond_net)
    jx = jnp.asarray(x.numpy())
    jx_down = jax_resize(jx, size=(S // SCALE, S // SCALE))
    conds = [cg_fn(state_dict_to_flax(net, sample_bayes(net, eps=e)), jx_down) for e in eps]

    def ie(cond):
        up = jax_resize(cond, scale=float(SCALE)).astype(jx.dtype)
        return np.asarray(ie_fn(ie_params, jnp.concatenate([jx, up], -1)))

    return dict(net=net, cond_net=cond_net, x=x, x_down=x_down, eps=eps, jx_down=jx_down,
                conds=jnp.concatenate(conds), ie=ie)


def _close(got, want):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def test_reduction_matches_bem_tpu(setup):
    assert setup["x_down"].shape == (1, S // SCALE, S // SCALE, 3)
    _close(setup["x_down"].numpy(), setup["jx_down"])


def test_sequential_matches_bem_tpu(setup):
    s = setup
    sums, pred = speed_test.sequential(s["net"], s["cond_net"], s["x"], s["x_down"], SCALE, K,
                                       eps=s["eps"])
    wants = [s["ie"](s["conds"][i:i + 1]) for i in range(K)]
    assert len(sums) == K and len(set(sums)) == K  # K distinct samples
    for got, want in zip(sums, wants):
        assert abs(got - float(want.sum())) <= TOL * abs(float(want.sum()))
    _close(pred.numpy(), wants[-1])


def test_speedup_matches_bem_tpu(setup):
    s = setup
    best, scores, pred = speed_test.speedup(s["net"], s["cond_net"], s["x"], s["x_down"],
                                            SCALE, K, eps=s["eps"])
    want_scores = np.asarray(jnp.mean(jnp.square(s["conds"]), axis=(1, 2, 3)))
    assert len(set(want_scores.tolist())) == K
    _close(scores.numpy(), want_scores)
    assert best == int(np.argmin(want_scores))
    _close(pred.numpy(), s["ie"](s["conds"][best][None]))


def _options(tmp_path, name, cfg):
    text = [f"name: {name}", "manual_seed: 0", "condition:", "  scale_down: 16", "network_g:"]
    text += [f"  {k}: {list(v) if isinstance(v, tuple) else v}" for k, v in cfg.items()
             if k != "bayesian"]
    path = tmp_path / f"{name}.yml"
    path.write_text("\n".join(text) + "\n")
    return str(path)


@pytest.mark.parametrize("mode", [[], ["--speedup"]])
def test_main_prints_running_time(tmp_path, capsys, mode):
    args = ["--opt", _options(tmp_path, "cg", CG), "--cond_opt", _options(tmp_path, "ie", IE),
            "--input_size", str(S), "--repeat", "2", "--dtype", "float32", "--device", "cpu"]
    speed_test.main(args + mode)
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"running time: \d+\.\d{4} sec", lines[-1]), lines


def test_spatial_shard_raises(tmp_path, setup):
    """``--spatial_shard 2`` raises in a world of one; on 2 ranks it runs:
    rank 0 prints the running time, and the sharded body's IE output (the
    "xla" route on each band of rows) matches bem_tpu's."""
    args = ["--opt", _options(tmp_path, "cg", CG), "--cond_opt", _options(tmp_path, "ie", IE),
            "--input_size", str(S), "--repeat", "2", "--dtype", "float32", "--device", "cpu",
            "--spatial_shard", "2"]
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        speed_test.main(args)
    res = spawn(workers.speed_test_run, 2, args=(args, args, setup["eps"][:1]))
    lines = res[0]["log"].strip().splitlines()
    assert re.fullmatch(r"running time: \d+\.\d{4} sec", lines[-1]), lines
    assert res[1]["log"] == ""
    _close(np.concatenate([r["pred"] for r in res], 1), setup["ie"](setup["conds"][:1]))
