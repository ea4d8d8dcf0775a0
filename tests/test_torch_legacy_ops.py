"""BasicSR's legacy ops (``ops/legacy.py``) and ``flow_warp`` /
``DCNv2Pack``: the port (channel-first) vs bem_tpu (channels-last) on the
same inputs, fp32, within 1e-5 of max(1, |bem_tpu|).

Cases: ``fused_leaky_relu`` with and without a bias; ``upfirdn2d`` up 2,
down 2, both, and negative pads, tests/test_legacy_ops.py's [1, 3, 3, 1]
kernel; the deformable convs at deform groups 1 and 2, stride 1 and 2,
with offsets that send samples past every border; ``flow_warp`` with
flows that leave the image; ``DCNv2Pack`` with its zero ``conv_offset``
and with a moved one (so the offsets move), weights carried by the
converter both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.ops.legacy as J
from bem_tpu.archs.arch_util import DCNv2Pack as JaxDCNv2Pack
from bem_tpu.archs.arch_util import flow_warp as jax_flow_warp
from bem_tpu_torch.archs.arch_util import DCNv2Pack, flow_warp
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import init
from bem_tpu_torch.ops import legacy as T

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _cf(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got: torch.Tensor, want):
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("bias", [False, True])
def test_fused_leaky_relu(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if bias else None
    want = J.fused_leaky_relu(jnp.asarray(x), None if b is None else jnp.asarray(b), 0.1, 1.5)
    got = T.fused_leaky_relu(_cf(x), None if b is None else torch.from_numpy(b), 0.1, 1.5)
    _close(got, want)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (1, 2)),
                                         (2, 1, (-1, 1)), (1, 1, (-2, -1)), (1, 2, (2, -1))])
def test_upfirdn2d(up, down, pad):
    x = np.random.default_rng(up + 3 * down).standard_normal((2, 9, 7, 3)).astype(np.float32)
    k = np.asarray(J.make_resample_kernel([1.0, 3.0, 3.0, 1.0]))
    np.testing.assert_array_equal(T.make_resample_kernel([1.0, 3.0, 3.0, 1.0]).numpy(), k)
    k = k * np.arange(1, 17, dtype=np.float32).reshape(4, 4)  # not symmetric: the flip shows
    want = J.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad)
    _close(T.upfirdn2d(_cf(x), torch.from_numpy(k), up, down, pad), want)


def _deform_inputs(seed, G, Ho, Wo, K=9, span=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 10, 12, 4)).astype(np.float32)
    # offsets up to +-span pixels: samples fall outside every border
    off = rng.uniform(-span, span, (2, Ho, Wo, 2 * G * K)).astype(np.float32)
    mask = rng.random((2, Ho, Wo, G * K)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 4, 5))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    return x, off, mask, w, b


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("stride,modulated", [(1, True), (2, True), (1, False)])
def test_deform_conv(groups, stride, modulated):
    Ho, Wo = (10, 12) if stride == 1 else (5, 6)
    x, off, mask, w, b = _deform_inputs(groups + stride, groups, Ho, Wo)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    if modulated:
        want = J.modulated_deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                                         jnp.asarray(w), jnp.asarray(b), stride, 1, 1, groups)
        got = T.modulated_deform_conv2d(_cf(x), _cf(off), _cf(mask), wt, torch.from_numpy(b),
                                        stride, 1, 1, groups)
    else:
        want = J.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), None, stride,
                               1, 1, groups)
        got = T.deform_conv2d(_cf(x), _cf(off), wt, None, stride, 1, 1, groups)
    _close(got, want)


@pytest.mark.parametrize("span", [0.0, 2.5, 40.0])
def test_flow_warp(span):
    rng = np.random.default_rng(int(span))
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    flow = rng.uniform(-span, span, (2, 9, 11, 2)).astype(np.float32)
    want = jax_flow_warp(jnp.asarray(x), jnp.asarray(flow))
    got = flow_warp(_cf(x), torch.from_numpy(flow), padding_mode="border")
    _close(got, want)
    if span == 0.0:
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), x)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("moved", [False, True])
def test_dcnv2_pack(groups, moved):
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 8, 10, 4)).astype(np.float32)
    feat = rng.standard_normal((2, 8, 10, 4)).astype(np.float32)
    jm = JaxDCNv2Pack(out_channels=6, kernel_size=3, deform_groups=groups)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feat))
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    assert not params["conv_offset"]["kernel"].any()
    if moved:  # offsets of a few pixels and a mask away from 1/2
        params["conv_offset"]["kernel"] = (
            0.3 * rng.standard_normal(params["conv_offset"]["kernel"].shape)).astype(np.float32)
        params["conv_offset"]["bias"] = rng.standard_normal(
            params["conv_offset"]["bias"].shape).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(feat))
    m = init.initialize(DCNv2Pack(4, 6, 3, groups), torch.Generator().manual_seed(0))
    assert not m.conv_offset.weight.any()
    load_flax_params(m, params)
    with torch.no_grad():
        _close(m(_cf(x), _cf(feat)), want)
    back = state_dict_to_flax(m)
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, a)
