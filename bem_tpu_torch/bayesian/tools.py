"""Bayesian-NN utilities over the port's ``mu_*`` / ``rho_*`` parameters.

Counterpart of bem_tpu/bayesian/tools.py:33-79. The prior is a dict
{parameter name: tensor} holding a copy of every ``mu_*`` / ``rho_*``
parameter, advanced toward the posterior once per train step before the
weights are sampled.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _is_bayes(name: str) -> bool:
    return name.rpartition(".")[2].startswith(("mu_", "rho_"))


def extract_bayes_prior(params: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """Initial prior: a detached copy of the (mu_*, rho_*) parameters; None
    when there are none."""
    prior = {k: v.detach().clone() for k, v in params.items() if _is_bayes(k)}
    return prior or None


@torch.no_grad()
def update_prior_ema(prior, params, step: int, decay: float = 0.9998):
    """prior <- d * prior + (1 - d) * param with d = min(decay,
    (1 + step) / (10 + step)); ``step`` counts the stochastic training
    forwards so far (0-based). Returns the new prior."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    return {k: d * v + (1.0 - d) * params[k].detach() for k, v in prior.items()}


def get_kl_loss(params, prior) -> torch.Tensor:
    """Sum over Bayesian tensors of mean KL(N(mu, s) || N(mu_p, s_p)),
    s = softplus(rho)."""
    total = None
    for key, mu_p in prior.items():
        head, _, leaf = key.rpartition(".")
        if not leaf.startswith("mu_"):
            continue
        rho_key = (head + "." if head else "") + "rho_" + leaf[3:]
        sigma_q = F.softplus(params[rho_key])
        sigma_p = F.softplus(prior[rho_key])
        kl = (torch.log(sigma_p) - torch.log(sigma_q)
              + (sigma_q ** 2 + (params[key] - mu_p) ** 2) / (2.0 * sigma_p ** 2) - 0.5)
        total = kl.mean() if total is None else total + kl.mean()
    return total
