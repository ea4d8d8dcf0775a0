"""ConditionGenerator, the Stage-I (Bayesian) trainer: counterpart of
bem_tpu/models/condition_generator_model.py.

The network is built Bayesian. A train step (condition_generator_model.py:
67-102) mixes the downsampled lq and gt when ``mixing_augs.mixup`` (as the
ImageEnhancer does), moves the EMA prior toward the current posterior
(decay min(0.998, (1+s)/(10+s))), samples one weight set, runs the forward
on the downsampled input (with the MIM mask while ``_use_mask`` holds),
and minimises L1 + 0.01 * KL / batch. Validation
(condition_generator_model.py:144) runs the mean weights, no sample.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..bayesian import get_kl_loss, update_prior_ema
from ..losses import build_loss
from ..nn.layers import sample_bayes
from ..utils.mixing_augment import mix, mixup_lam
from .base_model import BaseModel, reflect_pad


class ConditionGenerator(BaseModel):
    def __init__(self, opt, device="cuda", net=None):
        opt = dict(opt)
        network_g = dict(opt["network_g"], bayesian=True)
        network_g.setdefault("sigma_init", opt.get("sigma_init", 0.05))
        opt["network_g"] = network_g
        super().__init__(opt, device, net)
        self.bnn_decay = 0.998
        self.cond_type = opt.get("condition", {}).get("type", "mean")
        if self.is_train:
            train_opt = opt["train"]
            self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
            if self.cri_pix is None:
                raise ValueError("pixel loss required for ConditionGenerator")
            self.kl_batch = opt["datasets"]["train"].get("mini_batch_sizes", [8])[0]
            mixing = train_opt.get("mixing_augs", {})
            self.mixing_flag = mixing.get("mixup", False)
            self.mixup_beta = mixing.get("mixup_beta", 1.2)

    def _keys(self):
        if self.cond_type == "histogram":
            return "hist_lq", "hist_gt"
        return "lq_down", "gt_down"

    def train_step(self, batch, eps=None, lam=None):
        """One optimizer step on ``batch``. ``eps``: {mu parameter name:
        standard-normal tensor} for the weight sample (drawn from the
        trainer's generator when None); ``lam``: the mixup weight
        (``mixup_lam(beta, manual_seed, step)`` when None). Returns the
        step's logs."""
        lq_key, gt_key = self._keys()
        b = self._batch(batch)
        lq, gt = b[lq_key], b[gt_key]
        if self.mixing_flag:
            if lam is None:
                lam = mixup_lam(self.mixup_beta, self.opt.get("manual_seed") or 0, self.step)
            gt, lq = mix(gt, lq, lam)
        mask = b["mask"] if self._use_mask(batch) else None
        self.bayes_prior = update_prior_ema(self.bayes_prior, self.params, self.step,
                                            self.bnn_decay)
        sample = sample_bayes(self.net, gen=None if eps is not None else self.gen, eps=eps)
        preds = functional_call(self.net, sample, (lq, mask))[-1]
        l_kl = get_kl_loss(self.params, self.bayes_prior)
        l_pix = self.cri_pix(preds, gt)
        total = 0.01 * l_kl / self.kl_batch + l_pix
        aux = {"l_kl": l_kl,
               "l_pix": l_pix / self.opt["train"]["pixel_opt"].get("loss_weight", 1),
               "l_total": total}
        return self._apply_updates(self._grads(total), aux)

    @torch.no_grad()
    def nonpad_test(self, lq):
        """Deterministic forward: the mean weights (EMA params when kept)."""
        return functional_call(self.net, self._eval_state(), (lq.to(self.device),))[-1]

    @torch.no_grad()
    def sample(self, lq, gen: torch.Generator, num_samples: int = 1):
        """``num_samples`` forwards, each on its own weight sample from
        ``gen``; returns them stacked on a new leading axis."""
        lq = lq.to(self.device)
        return torch.stack([functional_call(self.net, sample_bayes(self.net, gen), (lq,))[-1]
                            for _ in range(num_samples)])

    def pad_test(self, lq, window_size: int):
        """Reflect-pad H and W to a multiple of ``window_size``, forward, crop."""
        h, w = lq.shape[1], lq.shape[2]
        return self.nonpad_test(reflect_pad(lq, window_size))[:, :h, :w, :]

    def _val_forward(self, val_data, window_size: int):
        lq_key, gt_key = self._keys()
        lq = torch.from_numpy(val_data[lq_key])
        out = self.pad_test(lq, window_size) if window_size else self.nonpad_test(lq)
        return out, val_data.get(gt_key)

    def _val_images_to_save(self, sr_img, gt_img):
        return () if self.cond_type == "histogram" else (sr_img,)
