"""``analysis.count_flops`` of the BEM nets does not depend on the device.

The serving wrappers (the stem and gdMlp kernels, the row pair, the column
pair, the tail and ``linear_scan``) state their work through
``ops._common.counted_as``: the FLOPs their plain versions' matmuls add up
to. So a net counts the same where its plain versions run (the CPU) and
where its kernels do, which FlopCounterMode does not see. The kernels'
side is played here by work-free stand-ins of the plain versions with the
same outputs' shapes (tests/test_torch_model_zoo_params.py's method). The
IE and CG ``Network``, the flagship ``DecompDualBranchDDWavelet`` and
``VMUNet`` at n_feat 8, blocks (1,1,1), 16x24.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bem_tpu_torch.analysis import count_flops
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.ops import gdmlp_fused, ss2d_seq, ss2d_tail

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)

NET = dict(out_channels=3, n_feat=8, num_blocks=(1, 1, 1), d_state=[1, 1, 1], ssm_ratio=1,
           mlp_ratio=4, mlp_type="gdmlp", use_pixelshuffle=True)
CASES = {
    "IE": dict(NET, type="Network", in_channels=6),
    "CG": dict(NET, type="Network", in_channels=3),
    "flagship": dict(NET, type="DecompDualBranchDDWavelet", in_channels=6,
                     decomp_model="model4"),
    "VMUNet": dict(NET, type="VMUNet", in_channels=6),
}


def _zeros(B, C, L, dtype):
    return torch.zeros(B, C, L, dtype=dtype)


def _stand_ins(monkeypatch):
    """Every serving wrapper's plain version replaced by a work-free one."""
    monkeypatch.setattr(gdmlp_fused, "_stem_plain", lambda x, W1, *a: _zeros(
        x.shape[0], W1.shape[0], x.shape[2], x.dtype))
    monkeypatch.setattr(gdmlp_fused, "_gdmlp_plain", lambda x, W1, b1, dw, bdw, W2, *a: _zeros(
        x.shape[0], W2.shape[0], x.shape[2], x.dtype))
    monkeypatch.setattr(ss2d_seq, "_pair_plain", lambda xs, fwd, rev: torch.zeros_like(xs))
    monkeypatch.setattr(ss2d_seq, "ss2d_col_sum_plain", lambda x, fwd, rev, H, W, T: tuple(
        torch.zeros(x.shape[0], W * -(-H // T), x.shape[1] * fwd[3].shape[-1])
        for _ in range(4)))
    monkeypatch.setattr(ss2d_seq, "ss2d_col_dir_plain", lambda x, *a: torch.zeros_like(x))
    monkeypatch.setattr(ss2d_seq, "linear_scan_plain", lambda a, b, reverse=False: b)
    monkeypatch.setattr(ss2d_tail, "_tail_plain", lambda y, yc, s, b, Wout, *a: _zeros(
        y.shape[0], Wout.shape[1], y.shape[2], y.dtype))


@pytest.mark.parametrize("case", list(CASES))
def test_count_flops_does_not_depend_on_the_route(monkeypatch, case):
    cfg = CASES[case]
    net = build_network(cfg, torch.Generator().manual_seed(0))
    if case == "flagship":
        net.load_frozen()
    x = torch.rand(1, 16, 24, cfg["in_channels"])
    summaries, recount = ss2d_seq.ss2d_col_sum_plain, []

    def summary_pass(*args):  # what FlopCounterMode sees of the column pair's first pass
        before = seen.get_total_flops()
        out = summaries(*args)
        recount.append(seen.get_total_flops() - before)
        return out

    with torch.no_grad():
        plain = count_flops(net, x)["flops"]
        with FlopCounterMode(display=False) as seen, monkeypatch.context() as m:
            m.setattr(ss2d_seq, "ss2d_col_sum_plain", summary_pass)
            net(x)
        _stand_ins(monkeypatch)
        hidden = count_flops(net, x)["flops"]
        with FlopCounterMode(display=False) as unstated:
            net(x)
    # the wrappers state their dt projections at every rank; torch's einsum
    # runs a rank-1 contraction as a product FlopCounterMode does not see.
    # The column pair's plain summary pass recomputes projections that its
    # full pass makes again; the pair states them once, as the row pair does
    assert recount and min(recount) > 0
    assert plain >= seen.get_total_flops() - sum(recount) > 0
    # the stand-ins hide the wrappers' work from FlopCounterMode ...
    assert unstated.get_total_flops() < plain
    # ... and the wrappers state it
    assert hidden == plain
