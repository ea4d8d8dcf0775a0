"""The ``Network`` options the port used to refuse, against bem_tpu.

Each case builds a small ``Network`` (n_feat 8, blocks (1,1,1), 16x16,
fp32) in the port from a seed, carries its weights to bem_tpu with
``state_dict_to_flax`` and holds the two forwards within 2e-5 of
max(1, |ref|):

- ``use_pixelshuffle: false`` (ConvDown / DeconvUp);
- ``mlp_type`` mlp / gmlp / ffnv02, deterministic and Bayesian (a weight
  sample drawn by the port, bem_tpu run on the same sample);
- ``sam``; ``last_act`` relu / softmax;
- ``drop_path`` with an injected keep mask (bem_tpu's bernoulli draw
  replaced by the same mask).

bem_tpu runs its XLA scan backend here (measured 2e-7 to 5e-7 of the
output's scale); test_torch_network_options_pallas.py holds every option
at once against its Pallas kernels. Each case's parameter tree also
equals bem_tpu's init (names and shapes, the Bayesian FFNv02's grouped
depthwise conv included). And a gdMlp VSSBlock with a drop-path rate,
which runs unfolded, against bem_tpu's block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bem_tpu.archs import build_network as jax_build
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.nn import sample_bayes

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

TOL = 2e-5
BASE = dict(type="Network", in_channels=3, out_channels=3, n_feat=8, num_blocks=(1, 1, 1),
            d_state=1, ssm_ratio=1, mlp_ratio=2, mlp_type="gdmlp", use_pixelshuffle=True)
B, H, W = 2, 16, 16
CASES = {
    "no pixel-shuffle": dict(use_pixelshuffle=False),
    "mlp": dict(mlp_type="mlp"),
    "mlp bayesian": dict(mlp_type="mlp", bayesian=True),
    "gmlp": dict(mlp_type="gmlp"),
    "gmlp bayesian": dict(mlp_type="gmlp", bayesian=True),
    "ffnv02": dict(mlp_type="ffnv02"),
    "ffnv02 bayesian": dict(mlp_type="ffnv02", bayesian=True),
    "sam": dict(sam=True),
    "last_act relu": dict(last_act="relu"),
    "last_act softmax": dict(last_act="softmax"),
    "drop_path": dict(drop_path=0.5),
}
COMBINED = dict(use_pixelshuffle=False, mlp_type="ffnv02", bayesian=True, sam=True,
                last_act="relu", drop_path=0.5)
KEEP = np.array([True, False])  # the injected drop-path keep mask, one per image


def _x(seed=0):
    return np.random.default_rng(seed).random((B, H, W, 3)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def _close(got, want, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _bem_tpu(cfg, params, x, backend, monkeypatch):
    """bem_tpu's forward on ``params``; with a drop-path rate, its bernoulli
    draw returns KEEP and a "dropout" rng turns the drop-path on."""
    net = jax_build(dict(cfg, scan_backend=backend))
    rngs = {}
    if cfg.get("drop_path"):
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(KEEP).reshape(shape))
        rngs = {"dropout": jax.random.PRNGKey(0)}
    fn = jax.jit(lambda p, x: net.apply({"params": p}, x, rngs=rngs)[-1])
    return np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))


def _check(opts, backend, monkeypatch):
    cfg = dict(BASE, **opts)
    model = build_network(cfg, torch.Generator().manual_seed(7))
    x = _x()
    # the parameter tree of bem_tpu's init, names and shapes
    shapes = jax.eval_shape(jax_build(dict(cfg, scan_backend="xla")).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    assert _flat(state_dict_to_flax(model)) == _flat(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes["params"]))
    sample = sample_bayes(model, torch.Generator().manual_seed(1))
    assert bool(sample) == bool(cfg.get("bayesian"))
    drop = torch.from_numpy(KEEP) if cfg.get("drop_path") else None
    with torch.no_grad():
        got = functional_call(model, sample, (torch.from_numpy(x),),
                              dict(drop_mask=drop))[-1].numpy()
    want = _bem_tpu(cfg, state_dict_to_flax(model, sample), x, backend, monkeypatch)
    _close(got, want)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_bem_tpu(case, monkeypatch):
    got = _check(CASES[case], "xla", monkeypatch)
    if case == "last_act relu":
        assert got.min() >= 0.0 and (got == 0.0).any()
    if case == "last_act softmax":
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_drop_path_mask_drops_and_scales():
    """The SubNetwork's residual: a dropped image's output is the net on
    x alone (the sub-network's output zeroed), a kept one's is x + f(x) / keep."""
    cfg = dict(BASE, drop_path=0.5)
    model = build_network(cfg, torch.Generator().manual_seed(7))
    x = torch.from_numpy(_x())
    with torch.no_grad():
        fea = model.first_conv(x.permute(0, 3, 1, 2))
        sub = model.subnets_0(fea) - fea  # the drop-path's input
        y = model(x, drop_mask=torch.from_numpy(KEEP))[-1]
        want = model.proj(fea + sub * torch.tensor([2.0, 0.0])[:, None, None, None])
        assert torch.allclose(y, want.permute(0, 2, 3, 1), atol=1e-6)
        # without a mask (or generator) the drop-path is off: no 1 / keep scale
        assert not torch.allclose(model(x)[-1], model(x, drop_mask=torch.ones(B, dtype=bool))[-1])


def test_unfolded_gdmlp_block_matches_bem_tpu():
    """A gdMlp VSSBlock with a drop-path rate cannot fold (vss.py:256): the
    port runs it unfolded, the gdMlp kernel on the LN'd map, against
    bem_tpu's block (drop-path off in both: no generator, no rng)."""
    from bem_tpu.nn.vss import VSSBlock as JaxVSSBlock
    from bem_tpu_torch.nn import VSSBlock, init

    block = init.initialize(VSSBlock(16, mlp_ratio=2, drop_path=0.2, bayesian=True),
                            torch.Generator().manual_seed(2))
    assert not block.fold
    x = np.random.default_rng(2).standard_normal((2, 16, 8, 12)).astype(np.float32)
    jb = JaxVSSBlock(hidden_dim=16, mlp_ratio=2, drop_path=0.2, bayesian=True,
                     scan_backend="xla")
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(block))
    want = jax.jit(lambda p, x: jb.apply({"params": p}, x))(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    _close(got, np.asarray(want))
