"""The training options the port used to refuse, against bem_tpu.

- The seven schedules of bem_tpu's ``_SCHEDULES``, with and without a
  warm-up, at every step over a range that spans each milestone, restart
  and period end: within 1e-6 relative (bem_tpu evaluates in float32, the
  port in float64: a few float32 ulps apart).
- ``Adam`` against ``optax.adam`` behind ``clip_by_global_norm`` in
  bem_tpu's ``multi_transform`` with a frozen subtree: five steps of seeded
  gradients, the parameters within 1e-6; and the trainer's ``.state`` tree
  in optax's layout.
- ``WeightedTVLoss``, ``PSNRLoss``, every ``my_loss`` function and
  ``CombinedLoss`` (the random VGG19 features of ``BEM_ALLOW_RANDOM_VGG=1``,
  which both packages draw alike), and every ``gan_loss`` function: within
  1e-6 relative; ``build_loss`` knows every name of bem_tpu's registry.

One trainer step with each option set against bem_tpu's trainers:
test_torch_train_options_ie.py and test_torch_train_options_cg.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bem_tpu.losses import LOSS_REGISTRY  # noqa: F401  (fills the registry)
from bem_tpu.losses import basic_loss as jbasic
from bem_tpu.losses import gan_loss as jgan
from bem_tpu.losses import my_loss as jmy
from bem_tpu.models import lr_scheduler as jsched
from bem_tpu.utils.registry import LOSS_REGISTRY as JAX_LOSSES
from bem_tpu_torch.losses import basic_loss, build_loss, gan_loss, my_loss
from bem_tpu_torch.models import lr_scheduler
from bem_tpu_torch.models.base_model import AdamWChain

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import random_vgg  # noqa: F401  (autouse)
from test_trainers import make_opt

BASE_LR = 2e-4
SCHEDULES = {
    "CosineAnnealingRestartCyclicLR": dict(periods=[10, 6, 8], restart_weights=[1, 0.5, 0.25],
                                           eta_mins=[1e-5, 2e-5, 1e-6]),
    "CosineAnnealingRestartLR": dict(periods=[10, 6, 8], restart_weights=[1, 0.5, 0.25],
                                     eta_min=1e-6),
    "MultiStepLR": dict(milestones=[5, 12, 18], gamma=0.5),
    "MultiStepRestartLR": dict(milestones=[5, 12, 18], gamma=0.5, restarts=[0, 10, 16],
                               restart_weights=[1, 0.5, 0.25]),
    "LinearLR": dict(total_iter=24),
    "VibrateLR": dict(total_iter=640),
    "TrueCosineAnnealingLR": dict(T_max=20, eta_min=1e-6),
}
STEPS = {"VibrateLR": range(0, 700, 3)}  # its period is total_iter // 80 = 8 steps


@pytest.mark.parametrize("warmup", [-1, 4])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_bem_tpu(name, warmup):
    opt = dict(SCHEDULES[name], type=name)
    port = lr_scheduler.with_warmup(lr_scheduler.build_schedule(BASE_LR, opt), warmup, BASE_LR)
    ref = jsched.with_warmup(jsched.build_schedule(BASE_LR, opt), warmup, BASE_LR)
    steps = list(STEPS.get(name, range(0, 30)))
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(steps, jnp.float32)), np.float64)
    got = np.asarray([port(s) for s in steps])
    # bem_tpu's float32 arithmetic against the port's float64: a few float32
    # ulps of each value (measured up to 3.8e-7 relative, at a cosine step),
    # past a floor of float32's resolution at the schedule's scale near 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=BASE_LR * 2 ** -24)
    assert len(set(np.round(got / BASE_LR, 6))) > 3  # the schedule moves


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "frozen.weight": (2, 2)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    # a frozen parameter gets no gradient in the trainers (its outputs carry
    # none), so the clip's norm is over the trained ones, as multi_transform's
    grads = [{k: torch.from_numpy((0 if k.startswith("frozen") else 3)
                                  * rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(5)]
    schedule = lr_scheduler.build_schedule(1e-2, dict(type="MultiStepLR", milestones=[2, 4]))
    opt = AdamWChain(params, schedule, 0.9, 0.99, weight_decay=0.5, max_norm=1.0,
                     frozen=["frozen.weight"], kind="Adam")
    assert opt.weight_decay == 0.0  # optax.adam has none: bem_tpu ignores it
    jsch = jsched.build_schedule(1e-2, dict(type="MultiStepLR", milestones=[2, 4]))
    tx = optax.multi_transform(
        {"train": optax.chain(optax.clip_by_global_norm(1.0), optax.adam(jsch, b1=0.9, b2=0.99)),
         "frozen": optax.set_to_zero()},
        {k: "frozen" if k.startswith("frozen") else "train" for k in shapes})
    jp = {k: jnp.asarray(p.numpy().copy()) for k, p in params.items()}  # no aliasing
    state = tx.init(jp)
    for g in grads:
        opt.step(params, g)
        upd, state = tx.update({k: jnp.asarray(v.numpy()) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert opt.count == 5


def test_adam_state_has_optax_layout():
    """A trainer with ``optim_g: Adam`` writes optax.adam's chain state."""
    from bem_tpu_torch.models import build_model

    popt = make_opt("ImageEnhancer")
    popt["train"]["optim_g"] = dict(type="Adam", lr=1e-3, weight_decay=1e-2)
    m = build_model(popt, device="cpu")
    chain = m.train_state()["opt_state"]
    assert set(chain) == {"0", "1"} and chain["0"] == {}  # the clip's empty state
    assert set(chain["1"]) == {"0", "1"} and set(chain["1"]["1"]) == {"count"}
    assert set(chain["1"]["0"]) == {"count", "mu", "nu"}


def _pair(rng, shape=(2, 24, 20, 3)):
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape).astype(np.float32), 0.0, 1.0)
    return a, b


def _rel(got, want, rel=1e-6, floor=1e-12):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), floor), (got, want)


def test_basic_losses_match_bem_tpu():
    rng = np.random.default_rng(1)
    a, b = _pair(rng)
    w = rng.random(a.shape).astype(np.float32)
    t = torch.from_numpy
    for red in ("mean", "sum"):
        port, ref = basic_loss.WeightedTVLoss(0.5, red), jbasic.WeightedTVLoss(0.5, red)
        _rel(port(t(a)), ref(jnp.asarray(a)))
        _rel(port(t(a), t(w)), ref(jnp.asarray(a), jnp.asarray(w)))
    port, ref = basic_loss.PSNRLoss(0.5, toY=True), jbasic.PSNRLoss(0.5, toY=True)
    _rel(port(t(a), t(b)), ref(jnp.asarray(a), jnp.asarray(b)))


MY_FUNCS = ["color_loss", "psnr_loss", "smooth_l1_loss", "ssim_loss", "multiscale_ssim_loss",
            "histogram_loss"]
# a difference of two float32 sums (1 - SSIM of close images, the
# difference of two means) cancels: those hold 1e-6 of max(1, |ref|), the
# SSIMs themselves 1e-6 relative (test_ssim_per_image_matches_bem_tpu);
# MS-SSIM's five levels of 11-tap float32 filters, summed in XLA's and
# torch's orders, 2e-6 (measured 1.07e-6)
TOLS = {"color_loss": (1e-6, 1.0), "ssim_loss": (1e-6, 1.0),
        "multiscale_ssim_loss": (2e-6, 1.0)}


@pytest.mark.parametrize("name", MY_FUNCS)
def test_my_loss_matches_bem_tpu(name):
    rng = np.random.default_rng(2)
    # MS-SSIM's five levels need 11 << 4 = 176 px; one odd side pads its pools
    shape = (2, 180, 177, 3) if name == "multiscale_ssim_loss" else (2, 24, 20, 3)
    a, b = _pair(rng, shape)
    if name == "histogram_loss":  # values on the bin edges and outside [0, 1]
        a.flat[:8] = [0.0, 1.0, 0.5, 0.25, -0.1, 1.1, 3 / 256, 255 / 256]
    got = getattr(my_loss, name)(torch.from_numpy(a), torch.from_numpy(b))
    _rel(got, getattr(jmy, name)(jnp.asarray(a), jnp.asarray(b)), *TOLS.get(name, (1e-6,)))


def test_ssim_per_image_matches_bem_tpu():
    a, b = _pair(np.random.default_rng(3), (2, 180, 177, 3))
    for fn in ("ssim", "ms_ssim"):
        got = getattr(my_loss, fn)(torch.from_numpy(a), torch.from_numpy(b), size_average=False)
        want = getattr(jmy, fn)(jnp.asarray(a), jnp.asarray(b), size_average=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_combined_loss_matches_bem_tpu():
    a, b = _pair(np.random.default_rng(4), (2, 32, 32, 3))
    port = build_loss(dict(type="CombinedLoss", loss_weight=0.5), device="cpu")
    ref = JAX_LOSSES.get("CombinedLoss")(loss_weight=0.5)
    _rel(port.perceptual(torch.from_numpy(a), torch.from_numpy(b)),
         ref.perceptual(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _rel(port(torch.from_numpy(a), torch.from_numpy(b)), ref(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("gan_type", list(gan_loss.GAN_TYPES))
def test_gan_losses_match_bem_tpu(gan_type):
    rng = np.random.default_rng(5)
    x = 3 * rng.standard_normal((2, 1, 6, 5)).astype(np.float32)
    xs = [x, [x[:, :, :3], 0.5 * x]]  # the multi-scale list, one entry a list
    for cls in ("GANLoss", "MultiScaleGANLoss"):
        port = getattr(gan_loss, cls)(gan_type, 0.9, 0.1, loss_weight=0.5)
        ref = getattr(jgan, cls)(gan_type, 0.9, 0.1, loss_weight=0.5)
        for real in (True, False):
            for disc in (True, False):
                _rel(port(torch.from_numpy(x), real, disc), ref(jnp.asarray(x), real, disc))
                if cls == "MultiScaleGANLoss":
                    t = [torch.from_numpy(xs[0]), [torch.from_numpy(v) for v in xs[1]]]
                    j = [jnp.asarray(xs[0]), [jnp.asarray(v) for v in xs[1]]]
                    _rel(port(t, real, disc), ref(j, real, disc))


def test_gan_penalties_match_bem_tpu():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    w = rng.random((3, 1, 1, 1)).astype(np.float32)
    _rel(gan_loss.r1_penalty(torch.from_numpy(g)), jgan.r1_penalty(jnp.asarray(g)))
    _rel(gan_loss.gradient_penalty_loss(torch.from_numpy(g)),
         jgan.gradient_penalty_loss(jnp.asarray(g)))
    _rel(gan_loss.gradient_penalty_loss(torch.from_numpy(g), torch.from_numpy(w)),
         jgan.gradient_penalty_loss(jnp.asarray(g), jnp.asarray(w)))


def test_build_loss_knows_bem_tpu_registry():
    names = set(JAX_LOSSES._obj_map) | {"PerceptualLoss"}
    assert names == {"L1Loss", "MSELoss", "CharbonnierLoss", "WeightedTVLoss", "PSNRLoss",
                     "CombinedLoss", "GANLoss", "MultiScaleGANLoss", "PerceptualLoss"}
    extra = {"PerceptualLoss": dict(layer_weights={"conv1_1": 1.0})}
    for name in names:
        assert build_loss(dict(type=name, **extra.get(name, {})), device="cpu") is not None
