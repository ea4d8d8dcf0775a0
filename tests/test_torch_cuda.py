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


@pytest.mark.cuda
def test_classifier_kernels_match_plain_on_card():
    """The fused SS2D core, its clamped form and its backward vs their plain
    versions at two tiny shapes (fp32, bf16), and their autograd wrappers'
    gradients vs the unclamped plain composition."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    for case in smoke.kernel_cases(small=True):
        if case.name in smoke.CLS_KERNELS:
            err, tol = smoke.compare(case)
            assert err <= tol, (case.name, case.label, case.dtype, err, tol)
    for case in smoke._cls_grad_cases(True, "cuda"):
        err, tol = smoke.compare_grads(case)
        assert err <= tol, (case.name, case.label, err, tol)


@pytest.mark.cuda
def test_classifier_on_card_matches_cpu():
    """A narrow VSSM (v2, d_state 16) on the card vs the CPU at B=1 (the
    fused core) and B=2 (its clamped form): logits and one loss gradient,
    within 1e-4 of their largest entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    import copy

    from bem_tpu_torch.classification import build_model_from_config, cross_entropy, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = get_config()
    v = c.MODEL.VSSM
    v.EMBED_DIM, v.DEPTHS = 16, [1, 1]
    c.MODEL.NUM_CLASSES, c.MODEL.DROP_PATH_RATE = 10, 0.0
    model = build_model_from_config(c, torch.Generator().manual_seed(0))
    for B in (1, 2):
        x = torch.rand((B, 32, 32, 3), generator=torch.Generator().manual_seed(B))
        y = torch.arange(B) % 10
        out = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model).to(dev)
            logits = m(x.to(dev))
            w = m.layer0_block0.op.x_proj_weight
            g, = torch.autograd.grad(cross_entropy(logits, y.to(dev)), [w])
            out[dev] = (logits.detach().cpu(), g.cpu())
        for a, b in zip(out["cuda"], out["cpu"]):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max(), (B, (a - b).abs().max())
