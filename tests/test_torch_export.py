"""``torch.export`` of the port's serving pipeline: the counterpart of
tests/test_export.py.

bem_tpu's test pipeline (the Bayesian CG K times on an 8x8 condition with
its weight noise as an input, the clip, the bilinear upsample to 32x32, the
IE on the K candidates) with tiny nets (n_feat 8, blocks (1, 1), K=4) on
the default route and on the "xla" route: exported, saved, loaded and run
as a callable without the model code; the graph holds the kernel rows'
bem:: operators; the artifact equals the live module within 1e-6; a wrong
shape raises. Then the refusals: a platform the port has no kernels for,
and NIQE's data-dependent host reading. tests/test_torch_export_serving.py
holds the serving module itself, tests/test_torch_export_ie.py an IE-only
artifact against bem_tpu's.
"""

import importlib

import numpy as np
import pytest
import torch
from torch import nn

from bem_tpu_torch.archs import build_network
from bem_tpu_torch.enhancement.export import export_pipeline, load_pipeline
from bem_tpu_torch.enhancement.pipeline import _cg_map, draw_eps, flagship_config
from bem_tpu_torch.metrics.niqe import NiqeCore
from bem_tpu_torch.nn import sample_bayes
from bem_tpu_torch.ops.resize import resize_bilinear

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)

K = 4
CFG = dict(flagship_config(n_feat=8, num_blocks=(1, 1)), stage=1, d_state=(1, 1))
# rows 1-7: the stem, the row pair, the tail, the gdMlp, the column pair's
# two passes and their linear_scan carry; the "xla" route runs row 8 (its
# carry on row 7 where L > S) and the plain stem / gdMlp
ROWS_1_7 = {"bem.stem_fused.default", "bem.ss2d_seq_pair.default", "bem.ss2d_tail.default",
            "bem.gdmlp_fused.default", "bem.ss2d_col_sum.default", "bem.ss2d_col_dir.default",
            "bem.linear_scan.default"}
ROUTES = {"default": ROWS_1_7, "xla": {"bem.ss2d_dir_fused.default"}}


class TinyPipeline(nn.Module):
    """tests/test_export.py's pipeline with the weight noise as an input,
    its K CG forwards the serving module's map."""

    def __init__(self, cg, ie):
        super().__init__()
        self.cg, self.ie = cg.eval(), ie.eval()

    def forward(self, eps, img, cond):
        conds = _cg_map(self.cg, sample_bayes(self.cg, eps=eps), cond)  # (K, 1, 8, 8, 3)
        conds = conds.clamp(0, 1).reshape(K, 8, 8, 3)
        up = resize_bilinear(conds, (32, 32))
        return self.ie(torch.cat([img.expand(K, 32, 32, 3), up], -1))[-1]


def _nets(route):
    cfg = dict(CFG, scan_backend=None if route == "default" else route)
    cg = build_network(dict(cfg, in_channels=3, out_channels=3, bayesian=True),
                       torch.Generator().manual_seed(0))
    ie = build_network(dict(cfg, in_channels=6, out_channels=3), torch.Generator().manual_seed(1))
    return cg, ie


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((1, 32, 32, 3), np.float32)),
            torch.from_numpy(rng.random((1, 8, 8, 3), np.float32)))


def _bem_nodes(loaded):
    """The bem:: operators a loaded artifact's graph calls."""
    return {str(n.target) for n in loaded.graph.nodes if str(n.target).startswith("bem.")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_export_roundtrip(tmp_path, route):
    module = TinyPipeline(*_nets(route))
    img, cond = _inputs()
    eps = draw_eps(module.cg, torch.Generator().manual_seed(7), K)
    with torch.no_grad():
        want = module(eps, img, cond)

    path = str(tmp_path / "pipe.pt2")
    export_pipeline(module, (eps, img, cond), path, platforms="cpu")
    g = load_pipeline(path)
    assert ROUTES[route] <= _bem_nodes(g)
    assert "map_impl" in {str(n.target) for n in g.graph.nodes}
    got = g(eps, img, cond)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    # shape mismatch fails loudly
    with pytest.raises(Exception):
        g(eps, torch.zeros(1, 16, 16, 3), cond)


@pytest.mark.parametrize("platforms", ["tpu", ("cpu", "cuda"), "cuda"])
def test_export_refuses_platforms(tmp_path, platforms):
    with pytest.raises(ValueError, match="platforms"):
        export_pipeline(lambda x: x + 1, (torch.ones(2),), str(tmp_path / "p.pt2"), platforms)


def test_np_cov_niqe_refuses_to_trace(tmp_path):
    core = NiqeCore(96, 96, "cpu", np_cov=True)
    with pytest.raises(RuntimeError, match="np_cov"):
        export_pipeline(core, (torch.rand(1, 96, 96) * 255,), str(tmp_path / "n.pt2"))


@pytest.mark.parametrize("module, name", [("torch._higher_order_ops.map", "map_impl"),
                                          ("torch.utils.flop_counter", "_FlopCounterMode")])
def test_private_torch_names(module, name):
    """The serving pipeline's K CG forwards (``_cg_map``) and the operators'
    FlopCounterMode rule (ops/_common.py) use these private torch names: a
    torch that moves one fails here first."""
    assert callable(getattr(importlib.import_module(module), name))
