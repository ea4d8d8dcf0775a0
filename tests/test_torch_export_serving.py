"""The serving module's artifact (counterpart of tests/test_export.py, with
tests/test_torch_export.py): :class:`ServingPipeline` at its smallest size
exported (its K CG forwards one map) and loaded, against the live
``build_pipeline`` closure; and the closure's weight noise is
``draw_eps``'s.
"""

import numpy as np
import torch

from bem_tpu_torch.enhancement.export import export_pipeline, load_pipeline
from bem_tpu_torch.enhancement.pipeline import build_pipeline, draw_eps
from bem_tpu_torch.nn import sample_bayes

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_export import ROWS_1_7, _bem_nodes, _nets


def test_serving_pipeline_exports(tmp_path):
    """The serving module at its smallest size (96x96: one NIQE block,
    padded to 128x128): the artifact picks the live pipeline's candidates
    with its scores, and the live closure's draws are draw_eps's."""
    cg, ie = _nets("default")
    pipe = build_pipeline(nimg=1, K=2, device="cpu", dtype=torch.float32, H=96, W=96,
                          nets=(cg, ie))
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.random((1, 128, 128, 3), np.float32))
    cond = torch.from_numpy(rng.random((1, 8, 8, 3), np.float32))
    want = pipe(torch.Generator().manual_seed(3), img, cond)
    eps = draw_eps(pipe.module.cg, torch.Generator().manual_seed(3), 2)
    path = str(tmp_path / "serve.pt2")
    export_pipeline(pipe.module, (eps, img, cond), path)
    g = load_pipeline(path)
    assert ROWS_1_7 <= _bem_nodes(g)
    # the K CG forwards are one map over the weight samples in the graph
    assert "map_impl" in {str(n.target) for n in g.graph.nodes}
    sel, best, scores = g(eps, img, cond)
    assert torch.equal(best, want[1])
    torch.testing.assert_close(scores, want[2], rtol=1e-6, atol=0)
    torch.testing.assert_close(sel, want[0], rtol=1e-6, atol=1e-6)


def test_draw_eps_is_sample_bayes_order():
    cg, _ = _nets("default")
    eps = draw_eps(cg, torch.Generator().manual_seed(9), 3)
    gen = torch.Generator().manual_seed(9)
    for k in range(3):
        live = sample_bayes(cg, gen)
        injected = sample_bayes(cg, eps={n: e[k] for n, e in eps.items()})
        assert live.keys() == injected.keys()
        assert all(torch.equal(live[n], injected[n]) for n in live)
