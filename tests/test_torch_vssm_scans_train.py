"""v052d (bidi scans) in the bf16 stream and in training: the port vs bem_tpu.

Set-up and tolerances as test_torch_vssm_scans.py (logits) and
test_torch_classify_train.py (one make_trainer step of the narrow VSSM,
here with forward_type v052d: bem_tpu's selective_scan_fused in interpret
mode forward, its custom VJP through the unfolded composition backward).
"""

import pytest
import torch

from test_torch_classify_train import check_loss_and_gradients, check_updates, run_train_step
from test_torch_vssm_scans import check_v052d_logits
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def test_v052d_logits_bf16():
    check_v052d_logits(torch.bfloat16)


@pytest.fixture(scope="module")
def v052d_step():
    return run_train_step("v052d")


def test_v052d_train_step_loss_and_gradients(v052d_step):
    check_loss_and_gradients(v052d_step)


def test_v052d_train_step_updates_params(v052d_step):
    check_updates(v052d_step)
