"""analysis/ (FLOPs, parameters, throughput, ERF): the port vs bem_tpu.

- ``count_params`` of a narrow VSSM against bem_tpu's on the same tree;
- ``flops_selective_scan`` against bem_tpu's (the same formula);
- ``count_flops``: the port counts matmuls and convolutions
  (FlopCounterMode), bem_tpu reads XLA's cost analysis, which also counts
  elementwise work; both counts of one narrow VSSM are printed (run with
  -s), the port's is the dense layers' multiply-adds by hand;
- ``effective_receptive_field`` of a narrow BackboneVSSM (v052dc, the last
  feature map, its out-norm given a non-uniform scale) on two images
  against bem_tpu's, within 1e-5 of the map's largest entry, and
  ``erf_high_contribution_ratio`` on it;
- ``throughput`` and ``analyze_network`` run (no time is checked here).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.analysis import erf as jerf
from bem_tpu.analysis import flops_param as jfp
from bem_tpu.nn.vssm import VSSM as JVSSM
from bem_tpu.nn.vssm import BackboneVSSM as JBackboneVSSM
from bem_tpu_torch.analysis import (analyze_network, count_flops, count_params,
                                    effective_receptive_field, erf_high_contribution_ratio,
                                    flops_selective_scan, throughput)
from bem_tpu_torch.nn import VSSM, BackboneVSSM, init

from test_torch_cascade import jparams
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

NET_KW = dict(depths=(1, 1), dims=16, ssm_d_state=4, drop_path_rate=0.0,
              patchembed_version="v2", downsample_version="v3", forward_type="v052dc")


def _vssm(seed=0):
    return init.initialize(VSSM(num_classes=5, **NET_KW), torch.Generator().manual_seed(seed))


def test_count_params_matches():
    model = _vssm()
    assert count_params(model) == jfp.count_params(jparams(model))
    assert count_params(dict(model.named_parameters())) == count_params(model)


@pytest.mark.parametrize("kw", [dict(), dict(B=2, L=49, D=96, N=1, with_D=False, with_Z=True)])
def test_flops_selective_scan_matches(kw):
    assert flops_selective_scan(**kw) == jfp.flops_selective_scan(**kw)


def test_count_flops_both_counts():
    model = _vssm(1)
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    port = count_flops(model, torch.from_numpy(x))
    params = jparams(model)
    jm = JVSSM(num_classes=5, scan_backend="xla", **NET_KW)
    xla = jfp.count_flops(lambda v: jm.apply({"params": params}, v), jnp.asarray(x))
    print(f"narrow VSSM v052dc 32x32 B=1: port (FlopCounterMode) {port['flops']:.0f} FLOPs, "
          f"bem_tpu (XLA cost analysis) {xla['flops']:.0f} FLOPs")
    # the head alone: 2 * 32 * 5 multiply-adds' FLOPs are part of the port's count
    head = count_flops(model.head, torch.zeros(1, 32))["flops"]
    assert head == 2 * 32 * 5 and port["flops"] > head and port["bytes_accessed"] == -1.0
    assert xla["flops"] > 0
    stats = analyze_network(model, torch.from_numpy(x))
    assert stats["params"] == count_params(model) and stats["flops"] == port["flops"]


def test_erf_matches():
    kw = dict(NET_KW, out_indices=(0, 1))
    model = init.initialize(BackboneVSSM(**kw), torch.Generator().manual_seed(2))
    with torch.no_grad():  # an affine-free LN's channel sum is 0: give the out-norm a scale
        model.outnorm1.weight.copy_(torch.linspace(0.5, 1.5, 32))
    imgs = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    got = effective_receptive_field(model, imgs, device="cpu")
    jm = JBackboneVSSM(scan_backend="xla", **kw)
    want = jerf.effective_receptive_field(lambda p, v: jm.apply({"params": p}, v),
                                          jparams(model), imgs)
    assert got.shape == want.shape == (32, 32)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    assert erf_high_contribution_ratio(got) == pytest.approx(
        jerf.erf_high_contribution_ratio(want), abs=2.0 / got.size)


def test_throughput_runs():
    model = _vssm(4)
    x = torch.rand(2, 32, 32, 3)
    assert throughput(model, x, iters=2, warmup=1, batch=2) > 0


def test_new_modules_import_no_jax():
    code = ("import sys, bem_tpu_torch.analysis, bem_tpu_torch.ops.ssd, bem_tpu_torch.nn, "
            "bem_tpu_torch.classification; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'bem_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
