"""``scan_backend`` through the stack: the port's nets built with "xla"
against bem_tpu's same builds and weights.

bem_tpu's ``Network``, ``VSSBlock``, ``VSSM``, the Decomp and the VMUNet
archs take ``scan_backend`` and pass it down (unet_arch.py:239, vss.py:185,
vssm.py:75, decomp_archs.py:56, vmunet_archs.py:43). With "xla" every
VSSBlock runs bem_tpu's XLA route: the SS2D's unfused stem, the
4-direction core without the -10 clamp, and the gdMlp as three convs.

- The LOLv1 IE (6 input channels) and CG (3) ``Network``, the flagship
  ``DecompDualBranchDDWavelet``, ``VMUNet`` (n_feat 8, blocks (1,1,1),
  16x24, B=2) and a narrow ``VSSM`` (v05_noz, embed 16, depths (1,1)), the
  port's seeded weights carried to bem_tpu: fp32 within 1e-5 of
  max(1, |bem_tpu|); bf16 within 2e-2 of the output's largest entry (the
  port's bf16 rule, smoke.TOL; the VSSM's logits are of order 0.2).
- The clamp probe: every SS2D's dt bias at 12 (dt * A < -10 for every
  state) and its scan input 50 * (LN(x)_0 - LN(x)_1) through a centre-only
  depthwise conv, so SiLU of it vanishes on every channel where it is
  negative and y there is the decay of the carried state alone
  (tests/test_torch_model_zoo_swin_mamba.py's probe). The "xla" VSSM
  matches bem_tpu's within 1e-5, the U-Nets within bem_tpu's own fp32
  error (see the test); the same weights on the default route, whose
  serving kernels clamp, miss by more than 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.nn.vssm import VSSM as JaxVSSM
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.nn import init
from bem_tpu_torch.nn.ss2d import SS2D
from bem_tpu_torch.nn.vss import GDMlp, VSSBlock
from bem_tpu_torch.nn.vssm import VSSM

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

NET = dict(out_channels=3, n_feat=8, num_blocks=(1, 1, 1), d_state=[1, 1, 1], ssm_ratio=1,
           mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True)
CASES = {
    "IE": dict(NET, type="Network", in_channels=6),
    "CG": dict(NET, type="Network", in_channels=3),
    "flagship": dict(NET, type="DecompDualBranchDDWavelet", in_channels=6,
                     decomp_model="model4"),
    "VMUNet": dict(NET, type="VMUNet", in_channels=6),
    "VSSM": dict(depths=(1, 1), dims=16, num_classes=5, drop_path_rate=0.0,
                 forward_type="v05_noz", ssm_d_state=1, ssm_ratio=2.0),
}
B, H, W = 2, 16, 24


@pytest.fixture(autouse=True, scope="module")
def _bf16_einsum():
    """bf16 einsums with an fp32 result run on fp32 casts of their operands
    (the CPU XLA runtime has no bf16 x bf16 = f32 dot;
    tests/test_torch_network_bf16.py)."""
    orig = jnp.einsum

    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32 and any(
                getattr(o, "dtype", None) == jnp.bfloat16 for o in ops):
            ops = [o.astype(jnp.float32) for o in ops]
        return orig(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    jnp.einsum = einsum
    yield
    jnp.einsum = orig
    _APPLY.clear()
    jax.clear_caches()


def _port(case, backend):
    cfg = CASES[case]
    gen = torch.Generator().manual_seed(1)
    if case == "VSSM":
        return init.initialize(VSSM(scan_backend=backend, **cfg), gen).eval()
    net = build_network(dict(cfg, scan_backend=backend), gen)
    return (net.load_frozen() if case == "flagship" else net).eval()


def _input(case):
    c = 3 if case in ("CG", "VSSM") else 6
    hw = (32, 32) if case == "VSSM" else (H, W)
    return np.random.default_rng(len(case)).random((B, *hw, c)).astype(np.float32)


_APPLY = {}  # one jitted apply per case: the fp32 build and the probe share its compile


def _bem_tpu(case, params, x, dtype=jnp.float32):
    if case not in _APPLY:
        cfg = CASES[case]
        net = (JaxVSSM(scan_backend="xla", **cfg) if case == "VSSM"
               else jax_build(dict(cfg, scan_backend="xla")))
        _APPLY[case] = jax.jit(lambda p, v: net.apply({"params": p}, v))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    out = _APPLY[case](params, jnp.asarray(x, dtype))
    out = out if case == "VSSM" else out[-1]
    return np.asarray(out.astype(jnp.float32))


def _run(net, case, x, dtype=torch.float32):
    with torch.no_grad():
        out = net(torch.from_numpy(x).to(dtype))
    return (out if case == "VSSM" else out[-1]).float().numpy()


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def test_xla_route_is_unfused():
    net = _port("IE", "xla")
    blocks = [m for m in net.modules() if isinstance(m, VSSBlock)]
    assert blocks and not any(b.fold for b in blocks)
    assert all(m.xla and not m.fused_core for m in net.modules() if isinstance(m, SS2D))
    assert not any(m.fused for m in net.modules() if isinstance(m, GDMlp))
    default = _port("IE", None)
    assert all(b.fold for b in default.modules() if isinstance(b, VSSBlock))
    with pytest.raises(ValueError, match="scan_backend"):
        build_network(dict(CASES["IE"], scan_backend="tpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_xla_build_matches_bem_tpu_fp32(case):
    net = _port(case, "xla")
    x = _input(case)
    want = _bem_tpu(case, state_dict_to_flax(net), x)
    got = _run(net, case, x)
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_xla_build_matches_bem_tpu_bf16(case):
    net = _port(case, "xla")
    x = _input(case)
    want = _bem_tpu(case, state_dict_to_flax(net), x, jnp.bfloat16)
    got = _run(net, case, x, torch.bfloat16)
    scale = np.abs(want).max()
    if case != "VSSM":  # the image nets' outputs are of order 1; logits are relative
        assert scale >= 0.5, scale
    assert np.abs(got - want).max() <= 2e-2 * scale


def _clamp_probe(tree):
    """In place on a flax params tree: every SS2D (a dict with
    ``dt_projs_bias``) takes the probe's weights."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if "dt_projs_bias" in v:
            v["dt_projs_bias"][:] = 12.0
            k_in = v["in_proj"]["kernel"]
            k_in[:] = 0.0
            k_in[0], k_in[1] = 50.0, -50.0
            v["conv2d"]["kernel"][:] = 0.0
            v["conv2d"]["kernel"][1, 1] = 1.0
            if "bias" in v["conv2d"]:
                v["conv2d"]["bias"][:] = 0.0
        else:
            _clamp_probe(v)


def _bem_tpu_fp64(case, params, x):
    """bem_tpu's output computed in float64 (x64 on while it runs)."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        return _bem_tpu(case, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params), x.astype(np.float64),
                        jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", prev)
        jax.clear_caches()


@pytest.mark.parametrize("case", ["IE", "CG", "VSSM"])
def test_xla_route_is_unclamped(case):
    """The VSSM meets 1e-5 of bem_tpu's fp32 output. In the U-Nets the
    probe's out-norm LN normalizes the decayed state's small values, and
    there bem_tpu's own fp32 output lies 1e-5 to 1e-4 from its float64
    output (measured: 1.4e-5 on one IE block), so the port is held to
    bem_tpu's float64 output within twice bem_tpu's own fp32 distance, and
    never past 3e-4, well inside the default route's 1e-3 miss."""
    net = _port(case, "xla")
    tree = state_dict_to_flax(net)
    _clamp_probe(tree)
    load_flax_params(net, tree)
    x = _input(case)
    want = _bem_tpu(case, tree, x)
    got = _run(net, case, x)
    if case == "VSSM":
        assert rel_err(got, want) < 1e-5
    else:
        want64 = _bem_tpu_fp64(case, tree, x)
        err = rel_err(got, want64)
        assert err <= 2 * rel_err(want, want64) and err <= 3e-4
    clamped = load_flax_params(_port(case, None), tree)
    assert rel_err(_run(clamped, case, x), want) > 1e-3
