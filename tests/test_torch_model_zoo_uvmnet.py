"""UVMNet's pieces in the port against bem_tpu's: ``Mamba1D`` (the causal
depthwise conv1d with its HIO weight, the selective scan on
``linear_scan``'s plain version), ``UVMB`` at a small w x h, and one
``DoubleConv`` as UVMNet builds it (its UVMB at the fixed 64x64 working
size, so a d_model 4096 channel-sequence Mamba, and inference-mode
BatchNorm whose scale / bias and ``batch_stats`` mean / var are moved off
their constants). bem_tpu's ``init`` carried across by the converter, one
seeded input, the output within 1e-4 of max(1, |bem_tpu|), then the
converter's round trip (``batch_stats`` included). The whole UNet cannot
be narrowed (bem_tpu marks its forward slow): its parameter count is
held in test_torch_model_zoo_params.py."""

import numpy as np
import pytest

from bem_tpu.analysis.model_zoo import uvmnet as J
from bem_tpu_torch.analysis.model_zoo import uvmnet as T
from zoo_parity import TOL, assert_round_trip, perturb_constants, rel_err, run_both

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


@pytest.mark.parametrize("d_model,d_conv,L", [(8, 4, 12), (20, 3, 7)])
def test_mamba1d_matches_bem_tpu(d_model, d_conv, L):
    x = np.random.default_rng(d_model).standard_normal((2, L, d_model)).astype(np.float32)
    net = T.Mamba1D(d_model, d_conv=d_conv)
    want, got, v = run_both(J.Mamba1D(d_model, d_conv=d_conv), net, x, edit=perturb_constants,
                            channels_first=False)
    assert got.shape == want.shape == x.shape
    assert rel_err(got, want) < TOL
    assert_round_trip(net, v)


def test_uvmb_matches_bem_tpu():
    x = np.random.default_rng(1).standard_normal((2, 8, 6, 4)).astype(np.float32)
    net = T.UVMB(c=4, w=6, h=8)
    want, got, v = run_both(J.UVMB(c=4, w=6, h=8), net, x, edit=perturb_constants)
    assert got.shape == want.shape == x.shape
    assert rel_err(got, want) < TOL
    assert_round_trip(net, v)


def test_double_conv_matches_bem_tpu():
    x = np.random.default_rng(2).random((1, 12, 20, 3)).astype(np.float32)
    net = T.DoubleConv(3, 8, 6)
    want, got, v = run_both(J.DoubleConv(3, 8, 6), net, x, edit=perturb_constants)
    assert set(v) == {"params", "batch_stats"}
    assert got.shape == want.shape == (1, 12, 20, 8)
    assert rel_err(got, want) < TOL
    assert_round_trip(net, v)
