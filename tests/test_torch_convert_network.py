"""Reference PyTorch checkpoints into the port (``archs/convert_network.py``,
``utils/torch_convert.py``), against bem_tpu's converters.

A reference-layout state dict is built by an inverse of the layout rules
(``smoke.reference_state``, which chip_smoke.py writes its reference
checkpoints with: module paths renamed to the reference U-Net's, conv
kernels HWIO -> OIHW, transposed-conv kernels unflipped to (I, O, kh, kw),
dense kernels (in, out) -> (out, in), ``scale`` / ``slope`` -> ``weight``)
from the port's seeded nets. Then:

- bem_tpu's converter maps it back to the source params, leaf for leaf
  (so the inverse is right), and the port's converter equals bem_tpu's,
  leaf for leaf: ``Network`` deterministic and Bayesian (``mu_*`` /
  ``rho_*``), pixel-shuffle on (PatchMerging / DualUpSample) and off
  (conv / transposed conv), an m0-style ``conv2d.1`` key; the Decomp dual
  branch (``convert_dualbranch_state``, the flagship's ``branches``); and,
  in the port's converter alone, SAM blocks and FFNv02 / Mlp MLPs.
- A converted net, loaded by ``convert.load_flax_params``, runs bem_tpu's
  forward within 1e-5 (``Network`` on bem_tpu's XLA scan backend).
- A ``.pth`` round trip through ``convert_network_checkpoint`` (the
  ``params`` key, and a bare state dict), with the unused keys reported
  and a missing key raising KeyError.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.archs import convert_network as jconv
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.archs import convert_network as pconv
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.smoke import reference_state, write_reference_checkpoint

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

NB = (1, 1, 1)
NET = dict(type="Network", in_channels=3, out_channels=3, n_feat=8, num_blocks=NB,
           d_state=[1, 1, 1], ssm_ratio=1, mlp_ratio=2)
FLAGSHIP = dict(type="DecompDualBranchDDWavelet", in_channels=6, out_channels=3, n_feat=8,
                num_blocks=NB, d_state=1, ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp",
                use_pixelshuffle=True, decomp_model="model4")
CASES = {"deterministic": dict(use_pixelshuffle=True),
         "bayesian": dict(use_pixelshuffle=True, bayesian=True),
         "no pixel-shuffle": dict(use_pixelshuffle=False),
         "bayesian no pixel-shuffle": dict(use_pixelshuffle=False, bayesian=True)}

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _net(case, seed=0):
    return build_network(dict(NET, **CASES[case]), torch.Generator().manual_seed(seed))


def _source_tree(case):
    """The port's seeded params (pixel-shuffle on or off)."""
    return state_dict_to_flax(_net(case))


@pytest.mark.parametrize("case", list(CASES))
def test_network_converter_matches_bem_tpu(case):
    src = _source_tree(case)
    sd = reference_state(src)
    kw = dict(num_blocks=NB, use_pixelshuffle=CASES[case]["use_pixelshuffle"])
    want = jconv.convert_network_state(sd, **kw)
    _assert_same_tree(want, src)
    _assert_same_tree(pconv.convert_network_state(sd, **kw), want)


def test_m0_conv_key_matches_bem_tpu():
    sd = reference_state(state_dict_to_flax(_net("deterministic")))
    for k in [k for k in sd if k.endswith(".op.conv2d.weight")]:
        sd[k.replace(".conv2d.", ".conv2d.1.")] = sd.pop(k)
    kw = dict(num_blocks=NB, use_pixelshuffle=True)
    _assert_same_tree(pconv.convert_network_state(sd, **kw),
                      jconv.convert_network_state(sd, **kw))


def test_dualbranch_converter_matches_bem_tpu():
    net = build_network(FLAGSHIP, torch.Generator().manual_seed(2)).load_frozen()
    src = state_dict_to_flax(net)
    sd = reference_state({"branches": src["branches"]})
    sd.update({f"decomp.{k}": v for k, v in reference_state(src["decomp"]).items()})
    want = jconv.convert_dualbranch_state(sd, num_blocks=NB)
    _assert_same_tree(want, {"branches": src["branches"]})
    got = pconv.convert_dualbranch_state(sd, num_blocks=NB)
    _assert_same_tree(got, want)
    m = build_network(FLAGSHIP, torch.Generator().manual_seed(9)).load_frozen()
    load_flax_params(m, dict(got, decomp=src["decomp"]))
    x = torch.from_numpy(np.random.default_rng(3).random((1, 16, 16, 6), np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(m(x)[-1].numpy(), net(x)[-1].numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_converted_forward_matches_bem_tpu(case):
    """The converted reference checkpoint's forward (on mu for the Bayesian
    net) in the port against bem_tpu's on bem_tpu's converted tree."""
    sd = reference_state(state_dict_to_flax(_net(case)))
    kw = dict(num_blocks=NB, use_pixelshuffle=CASES[case]["use_pixelshuffle"])
    m = load_flax_params(_net(case, seed=5), pconv.convert_network_state(sd, **kw))
    x = np.random.default_rng(4).random((2, 16, 24, 3)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))[-1].numpy()
    net = jax_build(dict(NET, **CASES[case], scan_backend="xla"))
    params = jax.tree_util.tree_map(jnp.asarray, jconv.convert_network_state(sd, **kw))
    want = jax.jit(lambda p, v: net.apply({"params": p}, v)[-1])(params, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["ffnv02", "mlp"])
def test_sam_and_mlp_types_round_trip(mlp_type):
    """A Bayesian net with SAM after every block and an FFNv02 / Mlp (keys
    bem_tpu's converter does not map): reference layout and back through the
    port's converter gives the source tree, every key used."""
    cfg = dict(NET, use_pixelshuffle=False, bayesian=True, sam=True, mlp_type=mlp_type)
    src = state_dict_to_flax(build_network(cfg, torch.Generator().manual_seed(4)))
    sd = reference_state(src)
    assert any(".sam_blocks.0.basic_block_4.conv_layers.4.conv.0.weight" in k for k in sd)
    m = pconv._network_mapper(sd, num_blocks=NB, use_pixelshuffle=False)
    assert set(sd) == m.used
    _assert_same_tree(pconv.convert_network_state(sd, num_blocks=NB, use_pixelshuffle=False), src)


def test_checkpoint_round_trip(tmp_path):
    src = state_dict_to_flax(_net("bayesian"))
    sd = reference_state(src)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    kw = dict(num_blocks=NB, use_pixelshuffle=True)
    path = write_reference_checkpoint(str(tmp_path / "ckpt.pth"), _net("bayesian"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _assert_same_tree(pconv.convert_network_checkpoint(str(path), **kw), src)
    bare = tmp_path / "bare.pth"
    torch.save(dict(tensors, extra_buffer=torch.zeros(2)), bare)
    with pytest.warns(UserWarning, match=r"1 checkpoint keys unused.*extra_buffer"):
        _assert_same_tree(pconv.convert_network_checkpoint(str(bare), **kw), src)
    missing = dict(tensors)
    missing.pop("proj.weight")
    torch.save({"params": missing}, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match="proj.weight"):
        pconv.convert_network_checkpoint(str(tmp_path / "missing.pth"), **kw)
