"""LLFormer in the port against bem_tpu's at a narrow configuration (dim 8,
one block a stage, heads (1, 2, 2, 2), with the input skip): bem_tpu's
``init`` carried across by the converter (``fac``, ``temperature``, the
``coefficient*`` leaves and the unused ``skip_2_1_kernel`` as they are,
each constant leaf moved off its constant first),
one seeded input, the output within 1e-4 of max(1, |bem_tpu|); then the
converter's round trip, leaf for leaf."""

import numpy as np

from bem_tpu.analysis.model_zoo import LLFormer as JLLFormer
from bem_tpu_torch.analysis.model_zoo import LLFormer
from zoo_parity import TOL, assert_round_trip, perturb_constants, rel_err, run_both

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

KW = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 2, 2), skip=True)


def test_llformer_matches_bem_tpu():
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    net = LLFormer(**KW)
    want, got, v = run_both(JLLFormer(**KW), net, x, edit=perturb_constants)
    assert got.shape == want.shape == x.shape
    assert rel_err(got, want) < TOL
    assert_round_trip(net, v)
