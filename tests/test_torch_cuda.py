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


@pytest.mark.cuda
def test_scan_fused_and_microbench_match_plain_on_card():
    """selective_scan_fused (scans 1 and 2 inputs, fp32 and bf16, with the
    clamp probe; it must fail against the clamped function) and the two
    microbenchmark kernels vs their plain versions at tiny shapes, and
    selective_scan_fused's autograd wrapper vs the plain composition."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    for case in smoke.kernel_cases(small=True):
        if case.name in smoke.SCAN_KERNELS + smoke.MICROBENCH_KERNELS:
            err, tol = smoke.compare(case)
            assert err <= tol, (case.name, case.label, case.dtype, err, tol)
    for case in smoke._scan_fused_grad_cases("cuda"):
        err, tol = smoke.compare_grads(case)
        assert err <= tol, (case.name, case.label, err, tol)


@pytest.mark.cuda
def test_v052d_classifier_on_card_matches_cpu():
    """A narrow VSSM with forward_type v052d (d_state 16) on the card vs
    the CPU at B=2: logits and one loss gradient within 1e-4 of their
    largest entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    import copy

    from bem_tpu_torch.classification import build_model_from_config, cross_entropy, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = get_config()
    v = c.MODEL.VSSM
    v.EMBED_DIM, v.DEPTHS, v.SSM_FORWARDTYPE = 16, [1, 1], "v052d"
    c.MODEL.NUM_CLASSES, c.MODEL.DROP_PATH_RATE = 10, 0.0
    model = build_model_from_config(c, torch.Generator().manual_seed(0))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    y = torch.arange(2)
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        logits = m(x.to(dev))
        w = m.layer0_block0.op.x_proj_weight
        g, = torch.autograd.grad(cross_entropy(logits, y.to(dev)), [w])
        out[dev] = (logits.detach().cpu(), g.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), (a - b).abs().max()


@pytest.mark.cuda
def test_chunked_row_pair_and_tensor_core_gdmlp_edges_on_card():
    """The chunked row pair and the gdMlp's forms (tensor cores on bf16 up
    to C = 256, the CUDA cores on fp32 and wider bf16) vs their plain
    versions where their tiles have edges, and on the case only the
    weights' bf16 lo halves carry (smoke.edge_cases), at smoke.TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    for case in smoke.edge_cases():
        err, tol = smoke.compare(case)
        assert err <= tol, (case.name, case.label, case.dtype, err, tol)


@pytest.mark.cuda
def test_chunked_column_pair_and_fused_backward_on_card():
    """The redesigned column pair (per-chunk summaries, the carry over the
    chunk sequence, the two-direction full pass) and the fused core's
    chunked backward at small shapes: each pass vs its plain version, the
    column clamp-probe cases failing against the unclamped function, the
    backward bit-identical over two launches, and the whole column pair on
    the card vs its plain composition (one chunk per column) at smoke.TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    import numpy as np

    from bem_tpu_torch import smoke
    from bem_tpu_torch.ops import ss2d_seq

    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    for B, C, H, W in ((2, 40, 37, 21), (1, 24, 6, 33)):  # H off the chunk, H under it
        x = rng.standard_normal((B, C, H * W)).astype(np.float32)
        xs = x / (1.0 + np.exp(-x))
        for dtype in (torch.float32, torch.bfloat16):
            for probe in (False, True):
                w = smoke._scan_weights(rng, C, t, clamp=True)
                for case in smoke._col_cases(f"{H}x{W}", dtype, rng, t, xs, H, W, w, probe, "cuda"):
                    err, tol = smoke.compare(case)
                    assert err <= tol, (case.name, case.label, dtype, err, tol)
                    assert not probe or case.other_clamp > 1, (case.name, case.other_clamp)
            xt = t(xs).to(dtype)
            y0 = t(rng.standard_normal((B, C, H * W))).to(dtype)
            got = ss2d_seq.ss2d_col_pair(xt, *w, y0, H, W)
            want = ss2d_seq.ss2d_col_pair_plain(xt, *w, y0, H, W)
            assert (got.float() - want.float()).abs().max() <= \
                smoke.TOL[dtype] * max(1.0, want.float().abs().max().item())
    for i, (B, C, L, R, N) in enumerate(((2, 40, 70, 3, 16), (1, 24, 20, 2, 4))):
        case = smoke._fused_bwd_case("small", B, C, L, R, N, "cuda", 900 + i)
        err, tol = smoke.compare(case)
        assert err <= tol and case.repeatable, (case.label, err, tol)
