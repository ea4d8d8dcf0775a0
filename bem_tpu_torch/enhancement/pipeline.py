"""The two-stage Bayesian serving pipeline (counterpart of bench.py::build_pipeline).

One call, for NIMG images:
  1. the Bayesian condition generator (CG) runs K times on the x16
     downsampled input, each time with its own weight sample;
  2. the K conditions are clipped to [0, 1], bilinear-upsampled to the
     padded full resolution and concatenated with the full-res input;
  3. the image enhancer (IE) runs once on the K*NIMG candidates;
  4. NIQE scores the cropped candidates and argmin picks one per image.

:class:`ServingPipeline` is those steps as a module that takes the K
weight samples' noise as an input (a generator cannot be an input of an
exported program); :func:`build_pipeline`'s closure draws the noise and
calls it.
"""

from __future__ import annotations

from itertools import chain

import torch
from torch import nn
from torch._higher_order_ops.map import map_impl
from torch.func import functional_call

from ..archs import build_network
from ..metrics.niqe import NiqeCore, rgb_to_y_255
from ..nn.layers import sample_bayes, sample_noise
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


def draw_eps(cg: nn.Module, gen: torch.Generator, K: int) -> dict:
    """The K weight samples' noise for :class:`ServingPipeline`:
    ``{name of mu_*: (K, *shape)}`` on ``gen``'s device, drawn in the order
    ``sample_bayes(cg, gen)`` draws them K times (sample by sample, each in
    ``named_parameters`` order), so both give the same samples."""
    draws = [sample_noise(cg, gen) for _ in range(K)]
    return {name: torch.stack([d[name] for d in draws]) for name in draws[0]}


def _cg_map(cg: nn.Module, samples: dict, cond_in: torch.Tensor) -> torch.Tensor:
    """The K CG forwards as one ``map`` over the weight samples. Run live,
    ``map`` calls the body on each sample in turn and stacks the outputs;
    in an export the graph holds one CG forward, which it runs K times, so
    the artifact makes the same calls in the same order as the live
    pipeline. The map body takes every tensor it reads as an argument (the
    samples, the CG's other parameters and buffers, the input), so it is
    traced without dynamo. ``map_impl`` is a private name of torch's (see
    README's note on the pinned torch APIs)."""
    names = list(samples)
    rest = {n: t for n, t in chain(cg.named_parameters(), cg.named_buffers())
            if n not in samples}
    rnames = list(rest)

    def body(*flat):
        w = dict(zip(names, flat[:len(names)]))
        w.update(zip(rnames, flat[len(names):-1]))
        return (functional_call(cg, w, (flat[-1],))[-1],)

    return map_impl(body, [samples[n] for n in names], [rest[n] for n in rnames] + [cond_in])[0]


class ServingPipeline(nn.Module):
    """The four steps of one request as a module, the one body of both the
    live pipeline and its exported artifact (:mod:`.export`).

    ``forward(eps, img, cond_in) -> (selected, index, scores)``: ``eps`` is
    :func:`draw_eps`'s dict of the K weight samples' noise, img (nimg, Hp,
    Wp, 3) the reflect-padded input and cond_in (nimg, Hp/16, Wp/16, 3) the
    downsampled condition input, NHWC. Returns the selected (nimg, H, W, 3)
    crops, the chosen candidate per image (nimg,) and the NIQE scores (K,
    nimg). The stream runs in ``dtype``; the params stay fp32."""

    def __init__(self, cg: nn.Module, ie: nn.Module, nimg: int, K: int, H: int, W: int,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.cg, self.ie = cg, ie
        self.nimg, self.K, self.H, self.W, self.dtype = nimg, K, H, W, dtype
        self.Hp, self.Wp = padded_size(H, W)
        self.niqe = NiqeCore(H, W, device)

    def forward(self, eps: dict, img: torch.Tensor, cond_in: torch.Tensor):
        nimg, K, H, W, Hp, Wp = self.nimg, self.K, self.H, self.W, self.Hp, self.Wp
        hc, wc = Hp // SCALE_DOWN, Wp // SCALE_DOWN
        if img.shape != (nimg, Hp, Wp, 3) or cond_in.shape != (nimg, hc, wc, 3):
            raise ValueError(f"pipeline: img {tuple(img.shape)} / cond_in "
                             f"{tuple(cond_in.shape)} for nimg={nimg}, {Hp}x{Wp}")
        img, cond_in = img.to(self.dtype), cond_in.to(self.dtype)
        # the K weight samples at once (elementwise: each one's values are
        # those sample_bayes gives it alone), then one CG forward each
        samples = sample_bayes(self.cg, eps=eps)
        conds = _cg_map(self.cg, samples, cond_in)                 # (K, nimg, hc, wc, 3)
        conds = conds.clamp(0.0, 1.0).reshape(K * nimg, hc, wc, 3)
        up = resize_bilinear(conds, size=(Hp, Wp)).to(img.dtype)
        inp = torch.cat([img[None].expand(K, -1, -1, -1, -1).reshape(K * nimg, Hp, Wp, 3),
                         up], dim=-1)
        preds = self.ie(inp)[-1]                                   # (K*nimg, Hp, Wp, 3)
        cand = preds.reshape(K, nimg, Hp, Wp, 3)[:, :, :H, :W].clamp(0.0, 1.0)
        scores = self.niqe(rgb_to_y_255(cand.reshape(K * nimg, H, W, 3))).reshape(K, nimg)
        best = torch.argmin(scores, dim=0)
        return cand[best, torch.arange(nimg, device=best.device)], best, scores


def build_pipeline(nimg: int = 2, K: int = 16, device="cuda", dtype=torch.bfloat16,
                   seed: int = 0, H: int = 400, W: int = 600, nets=None):
    """Returns ``pipeline(gen, img, cond_in) -> (selected, index, scores)``.

    img (nimg, Hp, Wp, 3) is the reflect-padded input, cond_in
    (nimg, Hp/16, Wp/16, 3) the downsampled condition input, both NHWC in
    ``dtype``; ``gen`` is a generator that draws the K CG weight samples
    (:func:`draw_eps`). Returns the selected (nimg, H, W, 3) crops, the
    chosen candidate per image (nimg,) and the NIQE scores (K, nimg). The
    nets are the flagship config with weights drawn from ``seed`` (CG) and
    ``seed + 1`` (IE), or ``nets`` = (cg, ie). Params stay fp32; the stream
    runs in ``dtype``. ``pipeline.module`` is the :class:`ServingPipeline`
    it runs, which :func:`..export.export_pipeline` takes.
    """
    if nets is None:
        common = flagship_config()
        cg = build_network(dict(common, in_channels=3, out_channels=3, bayesian=True),
                           torch.Generator().manual_seed(seed))
        ie = build_network(dict(common, in_channels=6, out_channels=3),
                           torch.Generator().manual_seed(seed + 1))
    else:
        cg, ie = nets
    module = ServingPipeline(cg.to(device).eval(), ie.to(device).eval(), nimg, K, H, W, dtype,
                             device)

    @torch.inference_mode()
    def pipeline(gen, img, cond_in):
        return module(draw_eps(module.cg, gen, K), img, cond_in)

    pipeline.module = module
    return pipeline
