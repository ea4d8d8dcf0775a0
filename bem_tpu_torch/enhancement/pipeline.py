"""The two-stage Bayesian serving pipeline (counterpart of bench.py::build_pipeline).

One call, for NIMG images:
  1. the Bayesian condition generator (CG) runs K times on the x16
     downsampled input, each time with its own weight sample;
  2. the K conditions are clipped to [0, 1], bilinear-upsampled to the
     padded full resolution and concatenated with the full-res input;
  3. the image enhancer (IE) runs once on the K*NIMG candidates;
  4. NIQE scores the cropped candidates and argmin picks one per image.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ..archs import build_network
from ..metrics.niqe import niqe_batch_rgb
from ..nn.layers import sample_bayes
from ..ops.resize import resize_bilinear

SCALE_DOWN = 16
# the eval protocol reflect-pads to a multiple of 4 * scale so the /16
# condition grid divides the CG U-Net's two downsampling levels
WINDOW = 4 * SCALE_DOWN


def padded_size(H: int, W: int):
    return H + (-H) % WINDOW, W + (-W) % WINDOW


def flagship_config(n_feat: int = 40, num_blocks=(2, 2, 2)) -> dict:
    """Both nets' shared config (UNet_arch.py build_model defaults)."""
    return dict(type="Network", n_feat=n_feat, stage=1, num_blocks=tuple(num_blocks),
                d_state=1, ssm_ratio=1, mlp_ratio=4, mlp_type="gdmlp",
                use_pixelshuffle=True)


def build_pipeline(nimg: int = 2, K: int = 16, device="cuda", dtype=torch.bfloat16,
                   seed: int = 0, H: int = 400, W: int = 600, nets=None):
    """Returns ``pipeline(gen, img, cond_in) -> (selected, index, scores)``.

    img (nimg, Hp, Wp, 3) is the reflect-padded input, cond_in
    (nimg, Hp/16, Wp/16, 3) the downsampled condition input, both NHWC in
    ``dtype``; ``gen`` is a generator on ``device`` that draws the K CG weight
    samples. Returns the selected (nimg, H, W, 3) crops, the chosen
    candidate per image (nimg,) and the NIQE scores (K, nimg). The nets are
    the flagship config with weights drawn from ``seed`` (CG) and
    ``seed + 1`` (IE), or ``nets`` = (cg, ie). Params stay fp32; the stream
    runs in ``dtype``.
    """
    if nets is None:
        common = flagship_config()
        cg = build_network(dict(common, in_channels=3, out_channels=3, bayesian=True),
                           torch.Generator().manual_seed(seed))
        ie = build_network(dict(common, in_channels=6, out_channels=3),
                           torch.Generator().manual_seed(seed + 1))
    else:
        cg, ie = nets
    cg = cg.to(device).eval()
    ie = ie.to(device).eval()
    Hp, Wp = padded_size(H, W)
    hc, wc = Hp // SCALE_DOWN, Wp // SCALE_DOWN
    niqe = niqe_batch_rgb(H, W)

    @torch.inference_mode()
    def pipeline(gen, img, cond_in):
        if img.shape != (nimg, Hp, Wp, 3) or cond_in.shape != (nimg, hc, wc, 3):
            raise ValueError(f"pipeline: img {tuple(img.shape)} / cond_in "
                             f"{tuple(cond_in.shape)} for nimg={nimg}, {Hp}x{Wp}")
        img, cond_in = img.to(dtype), cond_in.to(dtype)
        conds = torch.stack([
            functional_call(cg, sample_bayes(cg, gen), (cond_in,))[-1]
            for _ in range(K)])                                    # (K, nimg, hc, wc, 3)
        conds = conds.clamp(0.0, 1.0).reshape(K * nimg, hc, wc, 3)
        up = resize_bilinear(conds, size=(Hp, Wp)).to(img.dtype)
        inp = torch.cat([img[None].expand(K, -1, -1, -1, -1).reshape(K * nimg, Hp, Wp, 3),
                         up], dim=-1)
        preds = ie(inp)[-1]                                        # (K*nimg, Hp, Wp, 3)
        cand = preds.reshape(K, nimg, Hp, Wp, 3)[:, :, :H, :W].clamp(0.0, 1.0)
        scores = niqe(cand.reshape(K * nimg, H, W, 3)).reshape(K, nimg)
        best = torch.argmin(scores, dim=0)
        return cand[best, torch.arange(nimg, device=best.device)], best, scores

    return pipeline
