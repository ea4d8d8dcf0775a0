"""The model zoo's attention and Mamba baselines (SwinIR, HAT, MambaIR) in
the port against bem_tpu's at narrow configurations (window 4, a block or
two a group; MambaIR at embed 32, whose CAB squeezes by 30): bem_tpu's
``init`` (its constant leaves moved off their constants) carried across by
the converter, one seeded input at batch 2, the output within 1e-4 of
max(1, |bem_tpu|), then the converter's round trip.

MambaIR's SS2D takes ``scan_backend="xla"``: at batch 2 and d_inner 64,
``pick_group`` is 2, where the Pallas route clamps the log-decay at -10 and
the XLA route does not. The probe gives dt * A < -10 everywhere and makes
the scan input vanish at some pixels (SiLU of a large negative), so that
y there is the decay of the carried state alone: the port must equal
bem_tpu's XLA output within 1e-5 and miss it by more than 1e-3 when its
SS2Ds take the clamped route."""

import numpy as np
import pytest
import torch

import bem_tpu.analysis.model_zoo as J
import bem_tpu_torch.analysis.model_zoo as T
from bem_tpu_torch.nn.ss2d import SS2D
from zoo_parity import TOL, assert_round_trip, perturb_constants, rel_err, run_both

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

CASES = {
    "SwinIR": (dict(embed_dim=12, depths=(2, 2), num_heads=(2, 3), window_size=4, upscale=2), 16),
    "SwinIR x3 padded": (dict(embed_dim=12, depths=(2,), num_heads=(3,), window_size=4,
                              upscale=3), 14),
    "HAT": (dict(embed_dim=12, depths=(2,), num_heads=(3,), window_size=4, squeeze_factor=4,
                 upscale=2), 16),
    "MambaIR": (dict(embed_dim=32, depths=(2,), upscale=2), 16),
}
MAMBAIR = dict(embed_dim=32, depths=(2,), upscale=2)


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


def _clamp_probe(v):
    """dt bias 12 (dt * A < -10 for every state), and the scan input
    50 * (LN(x)_0 - LN(x)_1) through a centre-only depthwise conv: SiLU
    of it vanishes on every channel at the pixels where it is negative."""
    for blk in v["params"]["layer_0"].values():
        if "self_attention" not in blk:
            continue
        sa = blk["self_attention"]
        sa["dt_projs_bias"][:] = 12.0
        k = sa["in_proj"]["kernel"]
        di = k.shape[1] // 2
        k[:, :di] = 0.0
        k[0, :di], k[1, :di] = 50.0, -50.0
        sa["conv2d"]["kernel"][:] = 0.0
        sa["conv2d"]["kernel"][1, 1] = 1.0
        sa["conv2d"]["bias"][:] = 0.0


def test_mambair_xla_route_is_unclamped():
    x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    net = T.MambaIR(**MAMBAIR)
    want, got, _ = run_both(J.MambaIR(**MAMBAIR), net, x, edit=_clamp_probe)
    assert rel_err(got, want) < 1e-5
    for m in net.modules():
        if isinstance(m, SS2D):
            assert m.xla
            m.xla = False  # the Pallas route: clamped where pick_group(B, d_inner) > 1
    with torch.no_grad():
        clamped = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel_err(clamped, want) > 1e-3
