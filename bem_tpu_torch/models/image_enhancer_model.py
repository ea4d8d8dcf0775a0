"""ImageEnhancer, the Stage-II trainer: counterpart of
bem_tpu/models/image_enhancer_model.py.

A train step (image_enhancer_model.py:63-102): condition noise on the
downsampled ground truth, bilinear upsample to the input size, concat with
the low-light input, the forward, the pixel loss, its gradients, and the
clip -> AdamW update. Perceptual loss, mixup and the MIM mask are not
ported and raise. Validation (image_enhancer_model.py:131) runs the EMA
params when kept, reflect-padded to ``val.window_size``, and scores the
uint8 outputs with the host metrics.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..losses import build_loss
from ..ops.resize import resize_bilinear
from .base_model import BaseModel, reflect_pad


class ImageEnhancer(BaseModel):
    def __init__(self, opt, device="cuda", net=None):
        super().__init__(opt, device, net)
        cond = opt.get("condition", {})
        self.cond_type = cond.get("type", "mean")
        self.noise_level = cond.get("noise_level", 0)
        if self.is_train:
            train_opt = opt["train"]
            if train_opt.get("perceptual_opt"):
                raise NotImplementedError("the perceptual loss is not ported")
            mixing = train_opt.get("mixing_augs", {})
            if mixing.get("mixup") or mixing.get("use_identity"):
                raise NotImplementedError("mixup is not ported")
            self.cri_pix = build_loss(train_opt["pixel_opt"])

    def _cond_key(self):
        return "hist_gt" if self.cond_type == "histogram" else "gt_down"

    @staticmethod
    def _build_input(lq, conds):
        up = resize_bilinear(conds, size=(lq.shape[1], lq.shape[2]))
        return torch.cat([lq, up], dim=-1)

    def train_step(self, batch, noise=None):
        """One optimizer step on ``batch`` (NHWC lq, gt and the condition).
        ``noise``: the standard-normal condition noise (drawn from the
        trainer's generator when None). Returns the step's logs."""
        b = self._batch(batch)
        conds = b[self._cond_key()]
        if noise is None:
            noise = torch.randn(conds.shape, generator=self.gen, device=self.device)
        conds = conds + self.noise_level * torch.as_tensor(noise, device=self.device)
        preds = self.net(self._build_input(b["lq"], conds))[-1]
        l_pix = self.cri_pix(preds, b["gt"])
        aux = {"l_pix": l_pix / self.opt["train"]["pixel_opt"].get("loss_weight", 1),
               "l_total": l_pix}
        self.last_visuals = {"pred": preds[0].detach().clamp(0.0, 1.0), "gt": b["gt"][0]}
        return self._apply_updates(self._grads(l_pix), aux)

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
