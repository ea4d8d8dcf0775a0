"""The QD subsystem's parts: the port vs bem_tpu/qd, same inputs and weights.

- ``RetinexLoss``, both weightings and ``recon_only``: every term within
  rtol 1e-5, and the gradients of the total with respect to the four
  quaternion maps within 1e-5 of their largest entry (``equal_R_loss``
  stops the gradient through R_high in both).
- The batched device PSNR / SSIM (``calculate_psnr_torch`` /
  ``calculate_ssim_torch``) vs ``calculate_psnr_jax`` / ``calculate_ssim_jax``
  within 1e-5, with and without a crop border.
- ``PairDataset`` train samples (crop, reflect-pad of an image under the
  patch, flips, rot90) equal to bem_tpu's from the same seed, twice over;
  val samples unchanged.
- ``make_schedule`` at each epoch boundary; the QD optimizer (``AdamWChain``,
  weight decay 0.01, no clip) against ``optax.adamw`` over 3 steps.
- ``compute_rci`` with the shipped model4 within 1e-5, the variance map too.
- ``CompactTwoBranchModel`` at 16x16: bem_tpu's parameter tree (names and
  shapes), and Q1 / Q2 within 1e-4 on the port's seeded weights.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bem_tpu.metrics.psnr_ssim import calculate_psnr_jax, calculate_ssim_jax
from bem_tpu.qd import CompactTwoBranchModel as JaxCompact
from bem_tpu.qd import Decomp as JaxDecomp
from bem_tpu.qd.convert import load_decomp_params as jax_load_decomp_params
from bem_tpu.qd.dataset import PairDataset as JaxPairDataset
from bem_tpu.qd.loss import RetinexLoss as JaxRetinexLoss
from bem_tpu.qd.rci import compute_rci as jax_compute_rci
from bem_tpu.qd.train import make_schedule as jax_make_schedule
from bem_tpu_torch.convert import load_flax_params, state_dict_to_flax
from bem_tpu_torch.metrics.psnr_ssim import calculate_psnr_torch, calculate_ssim_torch
from bem_tpu_torch.models import AdamWChain
from bem_tpu_torch.nn.init import initialize
from bem_tpu_torch.qd import CompactTwoBranchModel, Decomp, RetinexLoss, load_decomp_params
from bem_tpu_torch.qd.dataset import PairDataset
from bem_tpu_torch.qd.rci import compute_rci
from bem_tpu_torch.qd.train import make_schedule

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def quaternions():
    rng = np.random.default_rng(0)
    q = [rng.standard_normal((2, 20, 24, 4)).astype(np.float32) * 0.5 for _ in range(4)]
    low, high = (rng.random((2, 20, 24, 3), np.float32) for _ in range(2))
    return q, low, high


@pytest.mark.parametrize("extended,recon_only", [(False, False), (True, False), (True, True)])
def test_retinex_loss_matches_bem_tpu(quaternions, extended, recon_only):
    (q1l, q2l, q1h, q2h), low, high = quaternions
    jl, pl = JaxRetinexLoss(extended), RetinexLoss(extended)
    if recon_only:
        jfn = lambda *qs: jl.recon_only(qs[0], qs[1], low, qs[2], qs[3], high)  # noqa: E731
    else:
        want_terms = jl(q1l, q2l, low, q1h, q2h, high)
        jfn = lambda *qs: jl(qs[0], qs[1], low, qs[2], qs[3], high)["loss_Decom"]  # noqa: E731
    want_total, want_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(q1l, q2l, q1h, q2h)
    qs = [_nchw(q).requires_grad_() for q in (q1l, q2l, q1h, q2h)]
    if recon_only:
        total = pl.recon_only(qs[0], qs[1], _nchw(low), qs[2], qs[3], _nchw(high))
    else:
        terms = pl(qs[0], qs[1], _nchw(low), qs[2], qs[3], _nchw(high))
        assert set(terms) == set(want_terms)
        for k, v in want_terms.items():
            assert float(terms[k].detach()) == pytest.approx(float(v), rel=1e-5), k
        total = terms["loss_Decom"]
    assert float(total.detach()) == pytest.approx(float(want_total), rel=1e-5)
    for g, w in zip(torch.autograd.grad(total, qs), want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("crop_border", [0, 2])
def test_device_psnr_ssim_match_bem_tpu(crop_border):
    rng = np.random.default_rng(1)
    a = rng.random((3, 24, 32, 3), np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for mine, theirs in ((calculate_psnr_torch, calculate_psnr_jax),
                         (calculate_ssim_torch, calculate_ssim_jax)):
        want = np.asarray(theirs(jnp.asarray(a), jnp.asarray(b), crop_border))
        got = mine(torch.from_numpy(a), torch.from_numpy(b), crop_border).numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("qd_pairs")
    rng = np.random.default_rng(2)
    for kind in ("low", "high"):
        os.makedirs(root / kind)
    for name, h, w in (("a", 40, 48), ("b", 28, 36), ("c", 36, 40)):  # b is under the patch
        high = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "high" / f"{name}.png"), high)
        cv2.imwrite(str(root / "low" / f"{name}.png"), (high * 0.25).astype(np.uint8))
    return root


@pytest.mark.parametrize("train", [True, False])
def test_pair_dataset_matches_bem_tpu(pairs, train):
    args = (str(pairs / "low"), str(pairs / "high"), 32, train, 7)
    want, got = JaxPairDataset(*args), PairDataset(*args)
    assert len(got) == len(want) == 3
    for i in range(6):
        w, g = want[i % 3], got[i % 3]
        assert set(w) == set(g)
        for k in ("low", "high"):
            assert g[k].shape == w[k].shape and g[k].flags.c_contiguous
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} {i}")


def test_schedule_matches_bem_tpu():
    jfn, pfn = jax_make_schedule(3e-4, 30, 7), make_schedule(3e-4, 30, 7)
    for epoch in range(31):
        for step in (7 * epoch - 1, 7 * epoch, 7 * epoch + 1):
            if step >= 0:
                assert pfn(step) == pytest.approx(float(jfn(step)), rel=1e-5, abs=1e-12), step
    assert pfn(0) == pfn(7 * 10 - 1) == 3e-4 and pfn(7 * 10) < 3e-4  # constant for 10 epochs


def test_qd_optimizer_matches_optax_adamw():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sched = jax_make_schedule(3e-4, 3, 1, warmup_epochs=1)
    tx = optax.adamw(sched, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamWChain(tp, make_schedule(3e-4, 3, 1, warmup_epochs=1), weight_decay=0.01)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(g) for k, g in grads.items()})
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_rci_matches_bem_tpu():
    rng = np.random.default_rng(4)
    low = rng.random((16, 24, 3), np.float32) * 0.3
    high = rng.random((1, 16, 24, 3), np.float32)
    jnet, jparams = JaxDecomp("model4"), jax_load_decomp_params("model4")
    fwd = jax.jit(lambda x: jnet.apply({"params": jparams}, x))
    want, want_map = jax_compute_rci(fwd, low, high, return_variance_map=True)
    net = load_flax_params(Decomp("model4"), load_decomp_params("model4")).eval()
    got, got_map = compute_rci(net, low, high, return_variance_map=True, device="cpu")
    assert float(got) == pytest.approx(float(want), abs=1e-5)
    assert 0.0 <= float(got) <= 1.0
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=1e-5 * np.abs(want_map).max())


def test_compact_two_branch_model_matches_bem_tpu():
    x = np.random.default_rng(5).random((2, 16, 16, 3), np.float32)
    net = initialize(CompactTwoBranchModel(), torch.Generator().manual_seed(0))
    params = state_dict_to_flax(net)
    jnet = JaxCompact()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    flat = lambda t: {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v.shape)  # noqa: E731
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(params) == flat(shapes)
    want = jax.jit(lambda p, x: jnet.apply({"params": p}, x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (2, 4, 16, 16)
        np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()))
