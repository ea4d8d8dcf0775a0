"""Bayesian-NN utilities of the port (counterpart of bem_tpu/bayesian)."""

from .tools import extract_bayes_prior, get_kl_loss, update_prior_ema

__all__ = ["extract_bayes_prior", "get_kl_loss", "update_prior_ema"]
