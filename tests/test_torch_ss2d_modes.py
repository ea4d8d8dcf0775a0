"""SS2D m0, the out-norms, _oact, dropout and the SSM inits: the port vs bem_tpu.

SS2D maps (d_model 8, d_state 4, ssm_ratio 2, conv bias; B=2, 5x6) from
the port's seeded weights carried to bem_tpu with ``state_dict_to_flax``,
bem_tpu with scan_backend="pallas" (NHWC; the port runs channel-first),
fp32 within 1e-5 of max(1, |ref|):
- m0 with and without the z gate, act_layer "silu" and "gelu" (jax.nn.gelu's
  tanh form), and ``with_initial_state`` over two calls, each writing the
  state (bem_tpu's ``mutable=["ssm_state"]``): both outputs and the buffer;
- the parameter trees (names and shapes) of bem_tpu's init for m0 and the
  scan modes under initialize v0 / v1 / v2, and the v2 inits' values
  (A_logs 0, the dt bias and weight in [0, 0.1), Ds 1);
- each out-norm (none, dwconv3, cnorm, softmax, sigmoid) on the cross2d
  core (the 4-direction fused core, clamped at B=2 as bem_tpu's grouped
  kernel is) and on m0, and ``_oact``; the fused serving core is taken
  only with the LayerNorm out-norm;
- dropout after out_proj with an injected keep mask (bem_tpu's bernoulli
  draw returns the same mask), and identity without a generator or mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu_torch.convert import ssm_state_to_flax, state_dict_to_flax
from bem_tpu_torch.nn import SS2D, dropout, init

from test_torch_cascade import close, jax_ss2d, jparams, map_input, nhwc, port_ss2d
from test_torch_train import _flat
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def check_map(ftype, seed=0, x=None, **kw):
    model = port_ss2d(ftype, seed=seed, **kw)
    x = map_input() if x is None else x
    want = jax.jit(jax_ss2d(ftype, **kw).apply)({"params": jparams(model)}, jnp.asarray(nhwc(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    close(nhwc(got.numpy()), np.asarray(want), 1e-5)
    return model


@pytest.mark.parametrize("ftype,act", [("m0", "silu"), ("m0_noz", "silu"), ("m0", "gelu"),
                                       ("m0_noz", "gelu")])
def test_m0_map_matches(ftype, act):
    model = check_map(ftype, act_layer=act)
    assert model.m0 and model.Ds.shape == (4, model.R, model.d_inner // model.R)


def test_m0_head_width_must_divide():
    assert SS2D(20, ssm_ratio=1.0, forward_type="m0").Ds.shape == (4, 2, 10)  # dt rank 2
    with pytest.raises(ValueError, match="not divisible"):
        SS2D(20, ssm_ratio=1.0, forward_type="m0", dt_rank=3)


def test_m0_initial_state_over_two_calls():
    kw = dict(with_initial_state=True, chunk_size=8)
    model = port_ss2d("m0_noz", seed=2, **kw)
    jm = jax_ss2d("m0_noz", **kw)
    x1, x2 = map_input(seed=6), map_input(seed=7)
    variables = {"params": jparams(model),
                 "ssm_state": jax.tree_util.tree_map(jnp.asarray, ssm_state_to_flax(model))}
    assert variables["ssm_state"]["initial_state"].shape == (1, 4 * model.R, 16, 4)
    apply = jax.jit(lambda v, x: jm.apply(v, x, mutable=["ssm_state"]))
    for x in (x1, x2):
        want, upd = apply(variables, jnp.asarray(nhwc(x)))
        variables = {"params": variables["params"], "ssm_state": upd["ssm_state"]}
        with torch.no_grad():
            got = model(torch.from_numpy(x), update_state=True)
        close(nhwc(got.numpy()), np.asarray(want), 1e-5)
        close(model.initial_state.numpy(), np.asarray(upd["ssm_state"]["initial_state"]), 1e-5)
    assert np.abs(model.initial_state.numpy()).max() > 0
    before = model.initial_state.clone()
    with torch.no_grad():
        model(torch.from_numpy(x1))  # no update unless asked
    assert torch.equal(model.initial_state, before)


@pytest.mark.parametrize("ftype", ["m0", "v05_noz", "v052d", "v052dc"])
@pytest.mark.parametrize("initialize", ["v0", "v1", "v2"])
def test_init_parameter_tree_matches(ftype, initialize):
    model = port_ss2d(ftype, initialize=initialize)
    shapes = jax.eval_shape(jax_ss2d(ftype, initialize=initialize).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 6, 8)))["params"]
    want = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                                                  shapes)).items()}
    assert {k: v.shape for k, v in _flat(state_dict_to_flax(model)).items()} == want
    if initialize == "v2":
        assert (model.A_logs == 0).all() and (model.Ds == 1).all()
        held = [model.dt_projs_bias] + ([] if model.m0 else [model.dt_projs_weight])
        assert all((0 <= t).all() and (t < 0.1).all() and t.std() > 0 for t in held)
    elif initialize == "v1":
        assert 0.5 < model.A_logs.std() < 2.0 and 0.05 < model.dt_projs_bias.std() < 0.2


@pytest.mark.parametrize("norm", ["none", "dwconv3", "cnorm", "softmax", "sigmoid"])
@pytest.mark.parametrize("base", ["v05_noz", "m0"])
def test_out_norm_matches(norm, base):
    model = check_map(f"{base}_on{norm}", seed=3)
    assert not model.fused_core
    assert hasattr(model, "out_norm") == (norm in ("dwconv3", "cnorm"))


@pytest.mark.parametrize("ftype", ["v05_noz_oact", "v05_oact", "m0_noz_oact"])
def test_oact_matches(ftype):
    assert not check_map(ftype, seed=4).fused_core


@pytest.mark.parametrize("ftype", ["v05_noz", "v2", "v052dc", "m0"])
def test_dropout_with_injected_mask(ftype, monkeypatch):
    rate = 0.3
    model = port_ss2d(ftype, seed=5, dropout=rate)
    x = map_input(seed=8)
    keep = np.random.default_rng(9).random(x.shape) >= rate
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(nhwc(keep)).reshape(shape))
    want = jax.jit(lambda p, v: jax_ss2d(ftype, dropout=rate).apply(
        {"params": p}, v, rngs={"dropout": jax.random.PRNGKey(0)}))(jparams(model),
                                                                   jnp.asarray(nhwc(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), drop_mask=torch.from_numpy(keep))
        plain = model(torch.from_numpy(x))
        drawn = model(torch.from_numpy(x), gen=torch.Generator().manual_seed(0))
    close(nhwc(got.numpy()), np.asarray(want), 1e-5)
    assert torch.equal(got, torch.where(torch.from_numpy(keep), plain / (1 - rate), 0.0))
    kept = drawn != 0
    assert torch.equal(drawn[kept], plain[kept] / (1 - rate))
    assert 0.5 < kept.float().mean() < 0.9
    assert torch.equal(dropout(plain, rate), plain) and torch.equal(dropout(plain, 0.0, mask=kept),
                                                                    plain)


@pytest.mark.parametrize("norm", ["cnorm", "dwconv3", "ln"])
def test_reference_out_norm_keys_convert(norm):
    """The reference's get_outnorm Sequential keys (cnorm: out_norm.0 LN,
    out_norm.2 conv; dwconv3: out_norm.1 conv) land on the port's tree."""
    from bem_tpu_torch.archs.convert_network import _convert_ss2d, _Mapper

    model = port_ss2d(f"v05_on{norm}" if norm != "ln" else "v05", seed=6)
    ref_names = {"cnorm": {"out_norm.weight": "out_norm.0.weight",
                           "out_norm.bias": "out_norm.0.bias",
                           "out_norm_conv.weight": "out_norm.2.weight"},
                 "dwconv3": {"out_norm.weight": "out_norm.1.weight"}, "ln": {}}[norm]
    sd = {"op." + ref_names.get(k, k): v.numpy() for k, v in model.state_dict().items()}
    m = _Mapper(sd)
    _convert_ss2d(m, "op", "op")
    assert m.used == set(sd)
    want = _flat(state_dict_to_flax(model))
    got = {k[len("op/"):]: v for k, v in m.out.items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
