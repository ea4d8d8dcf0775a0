"""The model zoo's convolutional baselines (EDSR, RCAN, HWMNet,
RetinexFormer; LLFormer in test_torch_model_zoo_llformer.py) in the port
against bem_tpu's, each at a narrow configuration of its constructor's
fields: bem_tpu's ``init`` (its
constant leaves moved off their constants) carried across by the
converter, one seeded input, the output within 1e-4 of
max(1, |bem_tpu|); then the converter's round trip, leaf for leaf."""

import numpy as np
import pytest

import bem_tpu.analysis.model_zoo as J
import bem_tpu_torch.analysis.model_zoo as T
from zoo_parity import TOL, assert_round_trip, perturb_constants, rel_err, run_both

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

CASES = {
    "EDSR": (dict(num_feat=8, num_block=2, upscale=2), 16),
    "EDSR x3": (dict(num_feat=8, num_block=1, upscale=3, res_scale=0.5), 12),
    "RCAN": (dict(n_resgroups=2, n_resblocks=2, n_feats=16, reduction=4, scale=2), 16),
    "HWMNet": (dict(in_chn=3, wf=8, depth=3), 32),
    "RetinexFormer": (dict(n_feat=8, stage=2, num_blocks=(1, 1, 1)), 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_net_matches_bem_tpu(case):
    name = case.split()[0]
    kw, size = CASES[case]
    x = np.random.default_rng(len(case)).random((2, size, size, 3)).astype(np.float32)
    net = getattr(T, name)(**kw)
    want, got, v = run_both(getattr(J, name)(**kw), net, x, edit=perturb_constants)
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL
    assert_round_trip(net, v)
