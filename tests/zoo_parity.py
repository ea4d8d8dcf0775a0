"""Shared by the model zoo's CPU tests (tests/test_torch_model_zoo*.py):
one seeded input through a bem_tpu zoo module (its ``init`` variables,
jitted apply) and through the port's module with those variables loaded by
``bem_tpu_torch.convert``, and the converter's round trip back."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bem_tpu_torch.convert import batch_stats_to_flax, load_flax_params, state_dict_to_flax

TOL = 1e-4  # of max(1, |bem_tpu|): fp32 sums in another order, over a few blocks


def run_both(jax_mod, torch_mod, x, edit=None, channels_first=True):
    """(bem_tpu's output, the port's output, bem_tpu's variables) for the
    numpy input x (NHWC, or any token layout with ``channels_first=False``);
    ``edit`` may change the variables (numpy) before both runs."""
    v = jax.jit(jax_mod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: np.array(a, np.float32), v)
    if edit is not None:
        edit(v)
    want = np.asarray(jax.jit(jax_mod.apply)(v, jnp.asarray(x)))
    load_flax_params(torch_mod, v)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        if channels_first:
            xt = xt.permute(0, 3, 1, 2)
        got = torch_mod(xt)
        if channels_first:
            got = got.permute(0, 2, 3, 1)
    return want, got.numpy(), v


def perturb_constants(v, seed=0):
    """Move every constant leaf (LayerNorm and BatchNorm weights, biases and
    running statistics, RetinexFormer's ``rescale``, LLFormer's
    ``coefficient*`` / ``fac`` / ``temperature``, MambaIR's skip scales,
    the relative-position bias tables, Ds, PReLU slopes) off its constant,
    in place: a leaf read in the wrong layout, or a mix-up of two such
    leaves, then shows in the output."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, a in node.items():
            if isinstance(a, dict):
                walk(a)
            elif a.size and np.all(a == a.flat[0]):
                spread = max(abs(float(a.flat[0])), 0.1)
                node[k] = (a + spread * rng.uniform(-0.5, 0.5, a.shape)).astype(np.float32)

    walk(v)


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def assert_round_trip(torch_mod, v):
    """The port's parameters (and BatchNorm buffers) converted back equal
    bem_tpu's variables leaf for leaf."""
    back = {"params": state_dict_to_flax(torch_mod)}
    stats = batch_stats_to_flax(torch_mod)
    if stats:
        back["batch_stats"] = stats
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, a in want:
        np.testing.assert_array_equal(got[path], a, err_msg=jax.tree_util.keystr(path))
