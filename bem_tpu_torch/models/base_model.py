"""Base trainer: the network, its optimizer, schedule, EMA and Bayesian prior.

Counterpart of bem_tpu/models/base_model.py. JAX carries a functional
TrainState through a jitted step; here the trainer owns the module, an
explicit device and an explicit ``torch.Generator`` on it, and updates the
parameters in place (one copy of the weights instead of two). The
optimizer reproduces bem_tpu's optax chain (base_model.py:63-111):

    clip_by_global_norm(max_grad_norm) -> adamw(schedule, b1, b2, eps=1e-8,
                                                weight_decay)

- the clip scales by max_norm / ||g|| only when ||g|| >= max_norm (no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
- AdamW decays every parameter, biases and LayerNorm weights included;
- the learning rate of update k (k = 0, 1, ...) is ``schedule(k)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..archs import build_network
from ..bayesian import extract_bayes_prior
from .lr_scheduler import build_schedule, with_warmup


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamWChain:
    """The optax chain of bem_tpu's trainers, over a {name: parameter} dict."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 max_norm: float = 0.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        """Apply one update in place; returns the learning rate used."""
        if self.max_norm:
            g_norm = global_norm(grads.values())
            scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                                self.max_norm / g_norm)
            grads = {k: g * scale for k, g in grads.items()}
        lr = float(self.schedule(self.count))
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            mu = self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu = self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)
        return lr


class BaseModel:
    """Shared trainer skeleton; subclasses define ``train_step``.

    ``device`` is where the network, the batches and the generator live
    (CUDA unless the caller asks for the CPU); ``net`` is an already built
    network (e.g. with converted weights), else one is built from
    ``opt['network_g']`` with weights drawn from ``manual_seed``.
    """

    def __init__(self, opt: Dict[str, Any], device="cuda", net: Optional[torch.nn.Module] = None):
        self.opt = opt
        self.is_train = opt.get("is_train", False)
        self.device = torch.device(device)
        seed = opt.get("manual_seed") or 0
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if net is None:
            net = build_network(opt["network_g"], torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)
        self.params = dict(self.net.named_parameters())
        self.step = 0
        self.bayes_prior = extract_bayes_prior(self.params)
        self.ema_decay = 0.0
        self.ema_params = None
        if self.is_train:
            self._build_optimizer()

    def _build_optimizer(self):
        train_opt = self.opt["train"]
        optim_opt = dict(train_opt["optim_g"])
        optim_type = optim_opt.pop("type")
        base_lr = optim_opt.pop("lr")
        betas = optim_opt.pop("betas", (0.9, 0.999))
        wd = optim_opt.pop("weight_decay", 0.0)
        if optim_type != "AdamW":
            raise NotImplementedError(f"optimizer {optim_type} is not supported yet.")
        sched_opt = train_opt.get("scheduler")
        schedule = build_schedule(base_lr, sched_opt) if sched_opt else (lambda step: base_lr)
        self.lr_schedule = with_warmup(schedule, train_opt.get("warmup_iter", -1), base_lr)
        self.optimizer = AdamWChain(self.params, self.lr_schedule, betas[0], betas[1],
                                    weight_decay=wd, max_norm=train_opt.get("max_grad_norm", 0))
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            self.ema_params = {k: p.detach().clone() for k, p in self.params.items()}

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The array entries of ``batch`` as fp32 tensors on the device."""
        if "mask" in batch:
            raise NotImplementedError("the MIM mask input is not ported")
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, torch.float32)
        return out

    def _grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """d loss / d every parameter (zeros for one the loss does not reach)."""
        names = list(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return {k: torch.zeros_like(self.params[k]) if g is None else g
                for k, g in zip(names, gs)}

    def _apply_updates(self, grads, aux):
        """One optimizer step (+ EMA of the params); logs grad_norm and lr."""
        aux["grad_norm"] = global_norm(grads.values()).detach()
        aux["lr"] = self.optimizer.step(self.params, grads)
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, e in self.ema_params.items():
                    e.mul_(d).add_(self.params[k], alpha=1.0 - d)
        self.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}

    def _eval_state(self):
        """Parameter overrides of the deterministic forward: the EMA when kept."""
        return self.ema_params or {}

