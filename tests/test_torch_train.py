"""The training slice: the port's trainers vs bem_tpu's, same weights and noise.

- One ImageEnhancer and one ConditionGenerator train step against
  ``bem_tpu.models.build_model`` (tests/test_trainers.py-style options,
  n_feat 8, blocks (1,1,1), B=2, 32x32 with the condition at 8x8), on the
  XLA scan backend here and on the Pallas kernels in interpret mode in
  test_torch_train_pallas_{ie,cg}.py (each JAX compile takes tens of
  seconds). Both trainers start from the port's seeded weights, converted
  to flax params for bem_tpu. The IE's condition noise
  is the normal draw bem_tpu's step makes from its state rng; the CG's
  weight noise is numpy-seeded and injected into both (bem_tpu's layers
  read it in place of their ``bayes`` draw). Loss within 1e-5 relative;
  every gradient leaf within 1e-3 of the leaf's largest entry; the
  updated params within 1e-6 where the gradient is clearly nonzero (Adam's
  first step is lr * sign(g) there) and within one step (2 lr) elsewhere.
- The optimizer chain and schedule vs optax over 3 steps (1e-6).
- KL and the EMA prior vs bem_tpu.bayesian (1e-6).
- The Python options vs the YAML files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

import bem_tpu.nn.layers as jlayers
from bem_tpu.bayesian import get_kl_loss as jax_kl
from bem_tpu.bayesian import update_prior_ema as jax_ema
from bem_tpu.models import build_model as jax_build_model
from bem_tpu.models.lr_scheduler import build_schedule as jax_schedule
from bem_tpu.utils.options import yaml_load
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.bayesian import get_kl_loss, update_prior_ema
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import AdamWChain, build_model
from bem_tpu_torch.models.lr_scheduler import build_schedule
from bem_tpu_torch.ops.resize import resize_bilinear
from bem_tpu_torch.options import lolv1_options
from bem_tpu_torch.train import synthetic_batch, train

from test_trainers import make_batch, make_opt
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

HW, DOWN = 32, 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _capture_jax_grads(jm):
    """Make the JAX trainer hand its step's gradient tree out with the
    visuals (``last_visuals['grads']``)."""
    orig = jm._apply_updates

    def apply(state, grads, aux):
        aux["_visual_grads"] = grads
        return orig(state, grads, aux)

    jm._apply_updates = apply


def _capture_port_grads(pm):
    grads = {}
    orig = pm._apply_updates

    def apply(g, aux):
        grads.update(g)
        return orig(g, aux)

    pm._apply_updates = apply
    return grads


def _setup(model_type, backend, hw):
    batch = make_batch(np.random.default_rng(0), H=hw, W=hw, down=DOWN)
    popt = make_opt(model_type)
    net_opt = dict(popt["network_g"])
    if model_type == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=0.05)
    net = build_network(net_opt, torch.Generator().manual_seed(0))
    params0 = state_dict_to_flax(net)
    jopt = make_opt(model_type)
    jopt["network_g"]["scan_backend"] = backend
    jm = jax_build_model(jopt)
    # bem_tpu starts from the same weights (no init compile needed)
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    _capture_jax_grads(jm)
    pm = build_model(popt, device="cpu", net=net)
    return batch, jm, pm, params0


def _compare_step(jm, pm, jlogs, plogs, pgrads, params0):
    lj, lp = float(jlogs["l_total"]), float(plogs["l_total"])
    assert abs(lp - lj) <= 1e-5 * abs(lj), (lp, lj)
    assert abs(float(plogs["grad_norm"]) - float(jlogs["grad_norm"])) <= 1e-4 * float(
        jlogs["grad_norm"])
    assert float(plogs["lr"]) == pytest.approx(float(jlogs["lr"]), rel=1e-6)
    gj = _flat(jm.last_visuals["grads"])
    gp = _flat(state_dict_to_flax(pm.net, pgrads))
    pj = _flat(jax.tree_util.tree_map(np.asarray, jm.state.params))
    pp = _flat(state_dict_to_flax(pm.net))
    p0 = _flat(params0)
    assert set(gj) == set(gp) == set(pj) == set(pp)
    lr = float(jlogs["lr"])
    for k in gj:
        scale = np.abs(gj[k]).max()
        np.testing.assert_allclose(gp[k], gj[k], rtol=0, atol=1e-3 * scale + 1e-12,
                                   err_msg=f"grad {k}")
        moved = np.abs(pp[k] - pj[k])
        assert (moved <= 2 * lr * (1 + 1e-4 * np.abs(p0[k])) + 1e-6).all(), k
        clear = np.abs(gj[k]) > max(1e-5, 1e-2 * scale)
        assert (moved[clear] <= 1e-6 * (1 + np.abs(pj[k][clear]))).all(), f"param {k}"


def test_image_enhancer_step_matches_jax(backend="xla", hw=HW):
    batch, jm, pm, params0 = _setup("ImageEnhancer", backend, hw)
    # the condition noise bem_tpu's step draws (image_enhancer_model.py:64-67)
    _, noise_rng, _ = jax.random.split(jm.state.rng, 3)
    noise = np.asarray(jax.random.normal(noise_rng, batch["gt_down"].shape, jnp.float32))
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, noise=torch.from_numpy(noise.copy()))
    assert pm.step == int(jm.state.step) == 1
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)


def test_condition_generator_step_matches_jax(monkeypatch, backend="xla", hw=HW):
    batch, jm, pm, params0 = _setup("ConditionGenerator", backend, hw)
    rng = np.random.default_rng(5)
    eps = {k: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
           for k, p in pm.net.named_parameters() if k.rpartition(".")[2].startswith("mu_")}
    eps_tree = state_dict_to_flax(pm.net, eps)

    def bayes_weight(self, name, init_fn, shape, sigma_init):
        mu = self.param(f"mu_{name}", init_fn, shape)
        rho = self.param(f"rho_{name}", jlayers.inits.constant(
            jlayers.rho_from_sigma(sigma_init)), shape)
        if not self.has_rng("bayes"):
            return mu
        node = eps_tree
        for part in self.scope.path:
            node = node[part]
        return mu + jlayers.softplus_sigma(rho) * jnp.asarray(node[f"mu_{name}"])

    monkeypatch.setattr(jlayers._BayesParamMixin, "_bayes_weight", bayes_weight)
    jlogs = jm.train_step(batch)
    pgrads = _capture_port_grads(pm)
    plogs = pm.train_step(batch, eps=eps)
    assert float(plogs["l_kl"]) == pytest.approx(float(jlogs["l_kl"]), rel=1e-5, abs=1e-7)
    _compare_step(jm, pm, jlogs, plogs, pgrads, params0)
    prior_j = _flat(jm.state.bayes_prior)
    prior_p = _flat(state_dict_to_flax(pm.net, pm.bayes_prior))
    for k, v in prior_j.items():
        np.testing.assert_allclose(prior_p[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_optimizer_and_schedule_match_optax():
    """clip_by_global_norm(1) + adamw(schedule) over 3 steps, clipping on
    the first two (||g|| > 1) and not on the third."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sched_opt = {"type": "CosineAnnealingRestartCyclicLR", "periods": [2, 2],
                 "restart_weights": [1, 0.5], "eta_mins": [1e-4, 1e-6]}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jax_schedule(2e-3, sched_opt), b1=0.9, b2=0.999,
                                 weight_decay=1e-2))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamWChain(tp, build_schedule(2e-3, sched_opt), 0.9, 0.999, weight_decay=1e-2,
                     max_norm=1.0)
    for step, gscale in enumerate((3.0, 2.0, 0.05)):
        grads = {k: (rng.standard_normal(s) * gscale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        lr = opt.step(tp, {k: torch.from_numpy(g) for k, g in grads.items()})
        assert lr == pytest.approx(float(jax_schedule(2e-3, sched_opt)(step)), rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 149999, 150000, 150001, 196000, 196001, 299999])
def test_schedule_matches_jax(step):
    opt = lolv1_options("ImageEnhancer")["train"]["scheduler"]
    assert build_schedule(2e-4, opt)(step) == pytest.approx(
        float(jax_schedule(2e-4, opt)(step)), rel=1e-6)


def test_kl_and_prior_ema_match_jax():
    rng = np.random.default_rng(1)
    names = ["a.mu_weight", "a.rho_weight", "b.c.mu_bias", "b.c.rho_bias"]
    shapes = [(3, 4), (3, 4), (6,), (6,)]

    def draw(shift):
        return {n: (rng.standard_normal(s) * 0.1 + (shift if "rho" in n else 0.0))
                .astype(np.float32) for n, s in zip(names, shapes)}

    params, prior = draw(-3.0), draw(-2.5)
    nest = lambda d: {"a": {"mu_weight": d["a.mu_weight"], "rho_weight": d["a.rho_weight"]},  # noqa: E731
                      "b": {"c": {"mu_bias": d["b.c.mu_bias"], "rho_bias": d["b.c.rho_bias"]}}}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tprior = {k: torch.from_numpy(v) for k, v in prior.items()}
    assert float(get_kl_loss(tparams, tprior)) == pytest.approx(
        float(jax_kl(nest(params), nest(prior))), rel=1e-6)
    for step in (0, 7, 5000):
        new = update_prior_ema(tprior, tparams, step, 0.998)
        ref = _flat(jax_ema(nest(prior), nest(params), jnp.int32(step), 0.998))
        for n in names:
            np.testing.assert_allclose(new[n].numpy(), ref[n.replace(".", "/")], rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("name,model_type", [("IE", "ImageEnhancer"),
                                             ("CG", "ConditionGenerator")])
def test_options_match_yaml(name, model_type):
    assert lolv1_options(model_type) == yaml_load(f"Options/{name}_UNet_LOLv1.yml")


def test_train_loop_on_synthetic_batches():
    """A few IE steps through ``train`` at a small width: finite losses,
    logged at print_freq, the params move and the step count advances."""
    opt = _small_opt("ImageEnhancer")
    opt["datasets"]["train"]["gt_size"] = 32
    model = build_model(opt, device="cpu")
    before = {k: p.detach().clone() for k, p in model.params.items()}
    gen = torch.Generator().manual_seed(0)
    lines = []
    logs = train(model, (synthetic_batch(opt, gen, batch_size=2) for _ in range(4)),
                 print_freq=2, log=lines.append)
    assert model.step == 4 and len(lines) == 2 and lines[-1].startswith("iter 4 lr")
    assert np.isfinite(float(logs["l_total"])) and float(logs["grad_norm"]) > 0
    assert any(not torch.equal(before[k], p) for k, p in model.params.items())


def _small_opt(model_type, **train):
    opt = dict(lolv1_options(model_type), is_train=True)
    opt["network_g"] = dict(opt["network_g"], n_feat=8, num_blocks=[1, 1, 1])
    opt["train"] = dict(opt["train"], **train)
    return opt


def test_eval_forwards():
    """IE: pad_test reflect-pads to the window, runs the EMA params (when
    kept) and crops back. CG: nonpad_test runs the mean weights, sample
    draws a distinct weight set per forward."""
    rng = np.random.default_rng(2)
    batch = make_batch(rng, H=32, W=32, down=4)
    ie = build_model(_small_opt("ImageEnhancer", ema_decay=0.5), device="cpu")
    ie.train_step(batch)
    lq = torch.from_numpy(batch["lq"][:, :30, :30])
    conds = torch.from_numpy(batch["gt_down"])
    out = ie.pad_test(lq, conds, 8)
    padded = torch.nn.functional.pad(lq.permute(0, 3, 1, 2), (0, 2, 0, 2), mode="reflect")
    padded = padded.permute(0, 2, 3, 1)
    inp = torch.cat([padded, resize_bilinear(conds, size=(32, 32))], dim=-1)
    with torch.no_grad():
        ref = functional_call(ie.net, ie.ema_params, (inp,))[-1][:, :30, :30]
        live = ie.net(inp)[-1][:, :30, :30]
    assert out.shape == (2, 30, 30, 3)
    torch.testing.assert_close(out, ref)
    assert (out - live).abs().max() > 1e-6

    cg = build_model(_small_opt("ConditionGenerator"), device="cpu")
    lq = torch.from_numpy(batch["lq_down"])
    det = cg.nonpad_test(lq)
    torch.testing.assert_close(det, cg.nonpad_test(lq))
    ys = cg.sample(lq, torch.Generator().manual_seed(0), num_samples=3)
    assert ys.shape == (3, *lq.shape)
    assert (ys[0] - ys[1]).abs().max() > 1e-4 and (ys[0] - det).abs().max() > 1e-4
