"""The model zoo's registry and counts: ``BUILDERS`` holds bem_tpu's nine
keys; each builder's full comparison configuration has exactly bem_tpu's
parameter count (bem_tpu's through ``jax.eval_shape`` of its ``init``, the
port's built on the meta device, so no weights are made and no forward
runs); the builders return seeded weights; and ``count_flops`` counts the
SS2D core and the selective scan by what their wrappers state, not by
what their plain versions run, so a count does not depend on the route
(the card runs kernels FlopCounterMode cannot see)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bem_tpu.analysis.model_zoo as J
import bem_tpu_torch.analysis.model_zoo as T
from bem_tpu_torch.analysis import count_flops, count_params, flops_selective_scan
from bem_tpu_torch.analysis.model_zoo.uvmnet import Mamba1D
from bem_tpu_torch.ops import ss2d_fused

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

# the input size each bem_tpu net is initialised at (UVMNet's fixed 64x64)
INIT_SIZE = {"EDSR": 16, "RCAN": 16, "HWMNet": 32, "LLFormer": 32, "RetinexFormer": 16,
             "UVMNet": 64, "MambaIR": 8, "SwinIR": 8, "HAT": 8}


def test_builders_registry():
    assert sorted(T.BUILDERS) == sorted(J.BUILDERS) == [
        "EDSR", "HAT", "HWMNet", "LLFormer", "MambaIR", "RCAN", "RetinexFormer", "SwinIR",
        "UVMNet"]


@pytest.mark.parametrize("name", sorted(J.BUILDERS))
def test_full_config_param_count(name):
    s = INIT_SIZE[name]
    shapes = jax.eval_shape(J.BUILDERS[name]().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        net = T.BUILDERS[name]()
    assert count_params(net) == want


def test_builders_are_seeded():
    a = T.buildEDSR(device="cpu")
    b = T.buildEDSR(torch.Generator().manual_seed(0), device="cpu")
    c = T.buildEDSR(torch.Generator().manual_seed(1), device="cpu")
    wa, wb, wc = (n.conv_first.weight for n in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert torch.isfinite(wa).all() and wa.abs().max() > 0


def test_count_flops_does_not_depend_on_the_route(monkeypatch):
    torch.manual_seed(0)
    mambair = T.MambaIR(embed_dim=32, depths=(1,))
    mamba1d = Mamba1D(8)
    for m in (mambair, mamba1d):
        for p in m.parameters():
            torch.nn.init.uniform_(p, -0.1, 0.1)
    x_img, x_seq = torch.rand(1, 3, 8, 12), torch.rand(2, 10, 8)
    plain = count_flops(mambair, x_img)["flops"], count_flops(mamba1d, x_seq)["flops"]
    # the SS2D core's plain version replaced by a work-free stand-in of the
    # same output: a kernel's work, as FlopCounterMode sees it
    monkeypatch.setattr(ss2d_fused, "_fwd_plain",
                        lambda xs2, *w, clamp=False: torch.zeros_like(xs2))
    hidden = count_flops(mambair, x_img)["flops"], count_flops(mamba1d, x_seq)["flops"]
    assert plain == hidden
    # Mamba1D: its five projections and the causal conv (two FLOPs a
    # multiply-add), and the reference's estimate for the scan
    B, L, d, di, R, N, k = 2, 10, 8, 16, 1, 16, 4
    mm = d * 2 * di + di * (R + 2 * N) + R * di + di * d + di * k
    assert plain[1] == 2 * B * L * mm + flops_selective_scan(B, L, di, N)
