"""The port's CUDA kernels and gradients vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc; skips without one. Imports no JAX, so it
also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel vs its plain version at two small shapes, fp32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    for case in smoke.kernel_cases(small=True):
        err, tol = smoke.compare(case)
        assert err <= tol, (case.name, case.label, case.dtype, err, tol)


@pytest.mark.cuda
def test_gradients_match_plain_on_card():
    """Each autograd wrapper (kernel forward, backward on the card) vs its
    plain composition at three tiny shapes, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    for case in smoke.grad_cases(small=True):
        err, tol = smoke.compare_grads(case)
        assert err <= tol, (case.name, case.label, err, tol)
