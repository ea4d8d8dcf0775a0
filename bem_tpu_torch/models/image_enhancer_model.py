"""ImageEnhancer, the Stage-II trainer: counterpart of
bem_tpu/models/image_enhancer_model.py.

A train step (image_enhancer_model.py:63-102): condition noise on the
downsampled ground truth, mixup of gt and lq when ``mixing_augs.mixup``
(lam ~ Beta(mixup_beta, mixup_beta), the batch mixed with itself flipped
along axis 0, before the condition's upsample and concat), bilinear
upsample to the input size, concat with the low-light input, the forward
(with the MIM mask while ``_use_mask`` holds), the pixel loss and the
perceptual (VGG19) and style terms, their gradients, and the clip -> AdamW
update. ``mixing_augs.use_identity`` is not used, as in bem_tpu's trainer
(which reads it and ignores it). Validation (image_enhancer_model.py:131)
runs the EMA params when kept, reflect-padded to ``val.window_size``, and
scores the uint8 outputs with the host metrics.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..losses import build_loss
from ..losses.perceptual import build_perceptual
from ..ops.resize import resize_bilinear
from ..utils.mixing_augment import mix, mixup_lam
from .base_model import BaseModel, reflect_pad


class ImageEnhancer(BaseModel):
    def __init__(self, opt, device="cuda", net=None):
        super().__init__(opt, device, net)
        cond = opt.get("condition", {})
        self.cond_type = cond.get("type", "mean")
        self.noise_level = cond.get("noise_level", 0)
        if self.is_train:
            train_opt = opt["train"]
            self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
            self.cri_perceptual = (build_perceptual(train_opt["perceptual_opt"], self.device)
                                   if train_opt.get("perceptual_opt") else None)
            if self.cri_pix is None and self.cri_perceptual is None:
                raise ValueError("Both pixel and perceptual losses are None.")
            mixing = train_opt.get("mixing_augs", {})
            self.mixing_flag = mixing.get("mixup", False)
            self.mixup_beta = mixing.get("mixup_beta", 1.2)

    def _cond_key(self):
        return "hist_gt" if self.cond_type == "histogram" else "gt_down"

    @staticmethod
    def _build_input(lq, conds):
        up = resize_bilinear(conds, size=(lq.shape[1], lq.shape[2]))
        return torch.cat([lq, up], dim=-1)

    def train_step(self, batch, noise=None, lam=None):
        """One optimizer step on ``batch`` (NHWC lq, gt and the condition,
        optionally the MIM mask). ``noise``: the standard-normal condition
        noise (drawn from the trainer's generator when None); ``lam``: the
        mixup weight (``mixup_lam(beta, manual_seed, step)`` when None).
        Returns the step's logs."""
        b = self._batch(batch)
        lq, gt = b["lq"], b["gt"]
        conds = b[self._cond_key()]
        if noise is None:
            noise = torch.randn(conds.shape, generator=self.gen, device=self.device)
        conds = conds + self.noise_level * torch.as_tensor(noise, device=self.device)
        if self.mixing_flag:
            if lam is None:
                lam = mixup_lam(self.mixup_beta, self.opt.get("manual_seed") or 0, self.step)
            gt, lq = mix(gt, lq, lam)
        mask = b["mask"] if self._use_mask(batch) else None
        preds = self.net(self._build_input(lq, conds), mask)[-1]
        train_opt = self.opt["train"]
        total, aux = 0.0, {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(preds, gt)
            total = total + l_pix
            aux["l_pix"] = l_pix / train_opt["pixel_opt"].get("loss_weight", 1)
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(preds, gt)
            if l_percep is not None:
                total = total + l_percep
                aux["l_percep"] = l_percep / train_opt["perceptual_opt"].get("perceptual_weight", 1)
            if l_style is not None:
                total = total + l_style
        aux["l_total"] = total
        self.last_visuals = {"pred": preds[0].detach().clamp(0.0, 1.0), "gt": gt[0]}
        return self._apply_updates(self._grads(total), aux)

    @torch.no_grad()
    def nonpad_test(self, lq, conds):
        """Deterministic forward (EMA params when kept) with the condition
        upsampled to the input size."""
        inp = self._build_input(lq.to(self.device), conds.to(self.device))
        return functional_call(self.net, self._eval_state(), (inp,))[-1]

    def pad_test(self, lq, conds, window_size: int):
        """Reflect-pad H and W to a multiple of ``window_size``, forward, crop."""
        h, w = lq.shape[1], lq.shape[2]
        return self.nonpad_test(reflect_pad(lq, window_size), conds)[:, :h, :w, :]

    def _val_forward(self, val_data, window_size: int):
        lq = torch.from_numpy(val_data["lq"])
        conds = torch.from_numpy(val_data[self._cond_key()])
        out = self.pad_test(lq, conds, window_size) if window_size else self.nonpad_test(lq, conds)
        return out, val_data.get("gt")
