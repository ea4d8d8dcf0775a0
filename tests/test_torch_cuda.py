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
    """The chunked row pair and the gdMlp's forms (tensor cores up to C =
    256 on either stream, the CUDA cores above) vs their plain versions
    where their tiles have edges, and on the cases only the bf16 lo halves
    carry (smoke.edge_cases), at smoke.TOL."""
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
                for case in smoke._col_cases(f"{H}x{W}", dtype, rng.standard_normal, t, xs, H, W,
                                             w, probe, "cuda"):
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


@pytest.mark.cuda
def test_chunked_fused_forward_and_column_summary_grid_on_card():
    """The fused core's chunked forward (rows 8 / 10) at super-chunks of 32
    and 64 positions and one >= L: y vs the plain version per row with the
    clamp probe (failing against the other clamp setting) and the
    checkpoints vs fused_checkpoints_plain, also as smoke.checkpoint_cases
    holds them; and the column summaries (row 5) on their (column tile,
    chunk, image) grid at C = 160, where a block takes several chunks of its
    columns, with the clamp probe failing against the unclamped function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    import numpy as np

    from bem_tpu_torch import smoke
    from bem_tpu_torch.ops import ss2d_fused as fused

    for case in smoke.checkpoint_cases(small=True):
        err, tol, other = smoke.compare_checkpoints(case)
        assert err <= tol and other > 1, (case.label, case.dtype, case.clamp, err, tol, other)
    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    rows = lambda c: c.permute(0, 1, 2, 4, 3, 5).flatten(4)  # noqa: E731
    for B, C, L, R, N in ((2, 40, 100, 3, 16), (1, 70, 64, 3, 4), (2, 24, 20, 2, 1)):
        x = rng.standard_normal((B, 2, C, L)).astype(np.float32)
        xs2 = x / (1.0 + np.exp(-x))
        probe = torch.from_numpy(smoke._clamp_probe(xs2)).cuda()
        w = smoke._fused_weights(rng, C, R, N, t)
        for dtype in (torch.float32, torch.bfloat16):
            xs = t(xs2).to(dtype)
            wa = fused._args(xs, *w)
            for S in sorted({32, 64, -(-L // 32) * 32}):
                for clamp in (False, True):
                    y, ck = fused._fwd_kernels(xs, wa, clamp, True, S)
                    ref = fused.ss2d_dir_fused_plain(xs, *w, clamp=clamp)
                    err, tol = smoke.row_scaled(y, ref, smoke.TOL[dtype], probe)
                    assert err <= tol, (B, C, L, N, dtype, S, clamp, err, tol)
                    other = fused.ss2d_dir_fused_plain(xs, *w, clamp=not clamp)
                    err, tol = smoke.row_scaled(y, other, smoke.TOL[dtype], probe)
                    assert err > tol, (B, C, L, N, dtype, S, clamp, "other clamp", err, tol)
                    ckr = fused.fused_checkpoints_plain(xs, *w, clamp=clamp)
                    err, tol = smoke.row_scaled(rows(ck), rows(ckr), smoke.TOL[torch.float32])
                    assert err <= tol, (B, C, L, N, dtype, S, clamp, "checkpoints", err, tol)
    B, C, H, W = 2, 160, 109, 160  # chunks of 2 (fp32) / 4 (bf16) rows, 4 / 2 a block
    x = rng.standard_normal((B, C, H * W)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        w = smoke._scan_weights(rng, C, t, clamp=True)
        for case in smoke._col_cases("C160 109x160", dtype, rng.standard_normal, t,
                                     x / (1.0 + np.exp(-x)), H, W, w, True, "cuda"):
            if case.name == "ss2d_col_sum":
                err, tol = smoke.compare(case)
                assert err <= tol and case.other_clamp > 1, (dtype, err, tol, case.other_clamp)


@pytest.mark.cuda
def test_tensor_core_stem_and_chunked_selective_scan_on_card():
    """The stem's tensor-core form (bf16, C = Dh = 40 / 80 / 160, with and
    without the LN, and smoke.edge_cases' stem cases: K padding, Dh != C,
    tile remainders, the case only the LN output's lo halves carry, the
    CUDA-core form at C = 288) vs the plain version; selective_scan_fused
    as a chunked scan at super-chunks of 32 and 64 positions and one >= L
    (and smoke.edge_cases' cases at the S the source picks) vs the plain
    version per row with the clamp probe, failing against the clamped
    function; and the source's super-chunk rule at VMamba-T S0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    import numpy as np

    from bem_tpu_torch import smoke
    from bem_tpu_torch.ops import scan_fused as sf

    for case in smoke.edge_cases():
        if case.name in ("stem_fused_cf", "selective_scan_fused"):
            err, tol = smoke.compare(case)
            assert err <= tol, (case.name, case.label, case.dtype, err, tol)
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    for B, C, H, W in ((2, 40, 17, 70), (1, 80, 9, 40), (1, 160, 6, 33)):
        x = t(rng.standard_normal((B, C, H * W))).to(torch.bfloat16)
        for ln in (True, False):
            lns, lnb = (1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C))
            case = smoke._stem_case(f"{H}x{W} ln{int(ln)}", torch.bfloat16, rng, t, x, H, W,
                                    lns, lnb)
            if not ln:
                case.args = case.args[:7] + (None, None)
            err, tol = smoke.compare(case)
            assert err <= tol, (case.label, err, tol)
    for i, (B, C, L, N) in enumerate(((2, 24, 100, 16), (1, 40, 49, 4), (2, 16, 130, 1))):
        for case in smoke._scan_fused_edge(f"L{L} N{N}", B, C, L, N, "cuda", 40 + i):
            ins = sf._cuda_args(*case.args)
            ref = sf.selective_scan_fused_plain(*case.args)
            clamped = sf.selective_scan_fused_plain(*case.args, clamp=True)
            for S in sorted({32, 64, -(-L // 32) * 32}):
                y = sf._kernels(*ins, True, S)
                err, tol = smoke.row_scaled(y, ref, smoke.TOL[case.dtype], case.probe)
                assert err <= tol, (B, C, L, N, case.dtype, S, err, tol)
                err, tol = smoke.row_scaled(y, clamped, smoke.TOL[case.dtype], case.probe)
                assert err > tol, (B, C, L, N, case.dtype, S, "clamped", err, tol)
    # VMamba-T S0 (C 192, N 16, L 3136): 17 super-chunks of 192 positions at
    # batch 2 (8 sequences), one at batch 128
    assert sf.scan_chunk(8, 192, 16, 3136) == 192
    assert sf.scan_chunk(512, 192, 16, 3136) >= 3136


@pytest.mark.cuda
def test_single_pass_scan_and_tensor_core_tail_on_card():
    """linear_scan's walk and single-pass look-back forms and the tail's
    tensor-core and CUDA-core forms vs their plain versions at their
    edges (smoke.edge_cases: L = 1, the walk's limit, a chunk +- 1, several
    anchor groups, L = 2^20 at D = 1, D = 3072 over channel tiles; the
    tail at C = 40 padded to 48, C_out != C, L = 1, a tile + 1, the scalar
    path, C = 160), every linear_scan case bit-identical over two
    launches; linear_scan bit-identical over two launches at the training
    backward's (8, 16384, 40) and the IE-L0 carry (32, 8960, 40), both
    directions; one kernel launch a call at short and long L (profiler);
    and row 9's backward, whose carry then takes the look-back form,
    bit-identical over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from torch.profiler import ProfilerActivity, profile

    from bem_tpu_torch import smoke
    from bem_tpu_torch.ops.scan import linear_scan, linear_scan_plain, scan_plan

    for case in smoke.edge_cases():
        if case.name in ("linear_scan", "ss2d_tail_cf"):
            err, tol = smoke.compare(case)
            assert err <= tol, (case.name, case.label, case.dtype, err, tol)
            assert case.name != "linear_scan" or case.repeatable, case.label
    g = torch.Generator(device="cuda").manual_seed(0)
    for M, L, D in ((8, 16384, 40), (32, 8960, 40), (2, 35, 40)):
        a = torch.exp(-3 * torch.rand((M, L, D), generator=g, device="cuda"))
        b = torch.randn((M, L, D), generator=g, device="cuda")
        for rev in (False, True):
            h = linear_scan(a, b, rev)
            assert torch.equal(h, linear_scan(a, b, rev)), (M, L, D, rev)
            ref = linear_scan_plain(a, b, rev)
            assert (h - ref).abs().max() <= smoke.TOL[torch.float32] * max(1.0, ref.abs().max())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                linear_scan(a, b, rev)
                torch.cuda.synchronize()
            launches = sum(e.count for e in prof.key_averages()
                           if e.device_type.name == "CUDA" and "scan_" in e.key)
            assert launches == 1, (M, L, D, rev, launches, scan_plan(M, L, D))
    # 70 chunks of 32 positions: row 9's reverse carry over (4, 70, 96) looks back
    assert not scan_plan(4, 70, 96).walk
    case = smoke._fused_bwd_case("L2240", 1, 24, 2240, 2, 4, "cuda", 950)
    err, tol = smoke.compare(case)
    assert err <= tol and case.repeatable, (err, tol)


@pytest.mark.cuda
def test_fp32_tensor_core_stem_and_gdmlp_on_card():
    """The stem's and the gdMlp's fp32 tensor-core forms (three bf16
    products a projection) vs their plain versions at smoke.TOL: every fp32
    case of smoke.edge_cases up to C = 256 (tile remainders, Cout / Dh !=
    C, the lo-carried cases where each product carries a share far above
    the tolerance, the eval CG's B = 1 levels with the hidden width split
    over blocks), and the eval CLI's CG levels at B = 1; each bit-identical
    over two launches, each run by the tensor-core form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from bem_tpu_torch import smoke

    cases = [c for c in smoke.edge_cases() if c.dtype == torch.float32
             and c.name in ("stem_fused_cf", "gdmlp_fused_cf") and c.args[0].shape[1] <= 256]
    for i, shape in enumerate(smoke.EVAL_SHAPES[3:]):
        cases += [c for c in smoke._eval_cases(*shape, "cuda", seed=780 + i)
                  if c.name in ("stem_fused_cf", "gdmlp_fused_cf")]
    assert any("split" in smoke.kernel_form(c) for c in cases)
    for case in cases:
        assert smoke.kernel_form(case).startswith("tensor-core"), (case.name, case.label)
        err, tol = smoke.compare(case)
        assert err <= tol and case.repeatable, (case.name, case.label, err, tol)
