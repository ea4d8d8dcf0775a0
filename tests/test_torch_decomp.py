"""The QD decomposition's pieces: the port vs bem_tpu on the CPU.

- ``ops.wavelet`` (dwt2, iwt2, and iwt2(dwt2(x)) = x) and
  ``ops.quaternion`` (hamilton_product, rgb_to_quaternions) against
  bem_tpu's channels-last ops on the same numbers;
- ``nn.layers.ConvTranspose2d`` against bem_tpu's (k2 s2, NHWC
  ``lax.conv_transpose``) with a kernel whose 2x2 taps all differ: a
  transposed conv whose taps are not mirrored, or whose in / out axes are
  swapped, fails;
- ``qd.models.Decomp`` model1-4 on the shipped checkpoints, ``forward``
  and ``wavelet_features``, against bem_tpu's ``Decomp`` (jitted): 1e-5
  of the output's largest entry; the port's checkpoint copies are
  byte-identical to bem_tpu's, and the port reads them without flax into
  the same tree.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.nn.layers import ConvTranspose2d as JaxConvTranspose2d
from bem_tpu.ops import quaternion as jq
from bem_tpu.ops import wavelet as jw
from bem_tpu.qd import convert as jconvert
from bem_tpu.qd.models import Decomp as JaxDecomp
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn.layers import ConvTranspose2d
from bem_tpu_torch.ops import quaternion, wavelet
from bem_tpu_torch.qd import Decomp, load_decomp_params
from bem_tpu_torch.qd.convert import CHECKPOINT_DIR

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

MODELS = ("model1", "model2", "model3", "model4")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def test_wavelet_matches_bem_tpu():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    y = wavelet.dwt2(_nchw(x))
    assert y.shape == (2, 20, 4, 6)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jw.dwt2(jnp.asarray(x))), atol=1e-6)
    z = np.random.default_rng(1).standard_normal((2, 4, 6, 20)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(wavelet.iwt2(_nchw(z))), np.asarray(jw.iwt2(jnp.asarray(z))),
                               atol=1e-6)
    np.testing.assert_allclose(_nhwc(wavelet.iwt2(y)), x, atol=1e-6)


def test_quaternion_ops_match_bem_tpu():
    rng = np.random.default_rng(2)
    img = rng.random((2, 6, 7, 3)).astype(np.float32)
    img[0, 0, 0] = 0.0  # a black pixel: max + 1e-7 keeps it finite
    q = quaternion.rgb_to_quaternions(_nchw(img))
    assert q.shape == (2, 8, 6, 7) and torch.isfinite(q).all()
    np.testing.assert_allclose(_nhwc(q), np.asarray(jq.rgb_to_quaternions(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-6)
    a, b = (rng.standard_normal((2, 5, 3, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _nhwc(quaternion.hamilton_product(_nchw(a), _nchw(b))),
        np.asarray(jq.hamilton_product(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4)])
def test_conv_transpose_distinct_taps(cin, cout):
    """Taps 1, 10, 100, 1000 (times a per-channel factor): each output
    pixel of a 2x2 cell names the tap that made it."""
    rng = np.random.default_rng(3)
    taps = np.array([[1.0, 10.0], [100.0, 1000.0]], np.float32)
    kernel = (taps[:, :, None, None] * (1 + rng.random((1, 1, cin, cout)))).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    x = rng.random((2, 3, 4, cin)).astype(np.float32)
    jnet = JaxConvTranspose2d(cout, 2, 2)
    want = np.asarray(jnet.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    m = load_flax_params(ConvTranspose2d(cin, cout), {"kernel": kernel, "bias": bias})
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    assert got.shape == want.shape == (2, 6, 8, cout)
    _close(got, want, 1e-6)
    back = state_dict_to_flax(m)
    np.testing.assert_array_equal(back["kernel"], kernel)
    # the unmirrored taps give another function
    with torch.no_grad():
        m.weight.copy_(m.weight.flip(2, 3))
        assert np.abs(_nhwc(m(_nchw(x))) - want).max() > 1.0


@pytest.mark.parametrize("model", MODELS)
def test_checkpoint_copies_are_bem_tpus(model):
    name = f"{model}_999.msgpack"
    assert filecmp.cmp(os.path.join(CHECKPOINT_DIR, name),
                       os.path.join(jconvert.CHECKPOINT_DIR, name), shallow=False)
    ours, theirs = load_decomp_params(model), jconvert.load_decomp_params(model)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(ours), flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def image():
    img = np.random.default_rng(4).random((2, 16, 24, 3)).astype(np.float32)
    img[1, :4, :4] *= 0.05  # a dark corner, where Q1 = RGB / max is large
    return img


@pytest.mark.parametrize("model", MODELS)
def test_decomp_matches_bem_tpu(image, model):
    """forward -> (Q1, Q2) and wavelet_features -> (Q1_w, Q2_w) on the shipped
    checkpoint, the port against bem_tpu's ``Decomp``: 1e-5."""
    params = load_decomp_params(model)
    jnet = JaxDecomp(model_type=model)
    apply = jax.jit(lambda p, x: (jnet.apply({"params": p}, x),
                                  jnet.apply({"params": p}, x, method=JaxDecomp.wavelet_features)))
    (jq1, jq2), (jw1, jw2) = apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(image))
    net = load_flax_params(Decomp(model), params)
    with torch.no_grad():
        q1, q2 = net(_nchw(image))
        w1, w2 = net.wavelet_features(_nchw(image))
    assert q1.shape == (2, 4, 16, 24) and w1.shape == (2, 16, 8, 12)
    for got, want in ((q1, jq1), (q2, jq2), (w1, jw1), (w2, jw2)):
        _close(_nhwc(got), np.asarray(want), 1e-5)
