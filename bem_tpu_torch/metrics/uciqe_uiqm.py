"""The no-reference metrics UCIQE and UIQM (counterpart of
bem_tpu/metrics/uciqe_uiqm.py), batched over (K, H, W, 3) uint8 RGB
tensors on their device.

- UCIQE = 0.4680 sigma_chroma + 0.2745 contrast_lum + 0.2576 mean_sat on
  cv2's uint8 Lab / 255, in float64 as bem_tpu computes it. Its 1 % / 99 %
  luminance points come from ``np.histogram(lum, 65536)``: lum = L / 255
  takes at most 256 values, so the device counts each L and the host bins
  those values with their counts as weights, which is that histogram bin
  for bin (a flat image's +-0.5 range included).
- UIQM = 0.0282 UICM + 0.2953 UISM + 3.5753 UIConM on float32 samples:
  the alpha-trimmed means with bem_tpu's slice ``x[t_l + 1 : K - t_r]``,
  the Sobel (``scipy.ndimage.sobel``, whose ``reflect`` pads one pixel as
  a replicate pad) EME with the remainder in the last block and
  bem_tpu's 0.144 weight on the third channel, and the logAMEE contrast
  over whole 10 x 10 blocks. Element-wise steps round in float32 as
  bem_tpu's do; sums run in float64 and are rounded to float32 where
  bem_tpu's float32 sums end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.resize import pil_bicubic_resize_u8
from ..utils.color_util import rgb2lab_u8

_NBINS = 65536
_UCIQE_COE = (0.4680, 0.2745, 0.2576)
_UIQM_COE = (0.0282, 0.2953, 3.5753)
_UISM_LAMBDAS = (0.299, 0.587, 0.144)  # bem_tpu's weights, the 0.144 included


def _as_batch(img) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(img) if isinstance(img, np.ndarray) else img)
    if t.dtype != torch.uint8:
        t = t.to(torch.uint8)
    return t[None] if t.dim() == 3 else t


# ---------------------------------------------------------------------- UCIQE


def _uciqe_device(rgb: torch.Tensor):
    """The device half of UCIQE for (K, H, W, 3) uint8: (sigma_chroma,
    mean_sat) as float64 (K,) tensors and the (K, 256) counts of L."""
    lab_u8 = rgb2lab_u8(rgb)
    lab = lab_u8.to(torch.float64) / 255.0
    lum, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    chroma = torch.sqrt(a ** 2 + b ** 2)
    sat = chroma / torch.sqrt(chroma ** 2 + lum ** 2 + 1e-12)
    k = rgb.shape[0]
    aver_sat = sat.reshape(k, -1).mean(dim=1)
    aver_chr = chroma.reshape(k, -1).mean(dim=1)
    ratio = aver_chr[:, None, None] / chroma  # inf / nan where chroma is 0, as in numpy
    var_chr = torch.sqrt(torch.nanmean(torch.abs(1 - ratio ** 2).reshape(k, -1), dim=1))
    L = lab_u8[..., 0].reshape(k, -1).long()
    counts = torch.zeros(k, 256, dtype=torch.int64, device=rgb.device)
    counts.scatter_add_(1, L, torch.ones_like(L))
    return var_chr, aver_sat, counts


def _contrast_lum(counts: np.ndarray) -> float:
    """The luminance contrast of bem_tpu's ``np.histogram(lum, 65536)`` from
    one image's 256 counts of L."""
    present = np.nonzero(counts)[0]
    hist, _ = np.histogram(present / 255.0, _NBINS, weights=counts[present])
    cdf = np.cumsum(hist) / np.sum(hist)
    ilow = int(np.argmax(cdf > 0.0100))
    ihigh = int(np.argmax(cdf >= 0.9900))
    return (ihigh - 1) / (_NBINS - 1) - (ilow - 1) / (_NBINS - 1)


def uciqe_batch(rgb: torch.Tensor) -> np.ndarray:
    """UCIQE of each uint8 RGB image of (K, H, W, 3); only the counts and two
    scalars an image come to the host."""
    var_chr, aver_sat, counts = _uciqe_device(rgb)
    var_chr, aver_sat, counts = (t.cpu().numpy() for t in (var_chr, aver_sat, counts))
    c = _UCIQE_COE
    return np.array([c[0] * float(var_chr[i]) + c[1] * _contrast_lum(counts[i])
                     + c[2] * float(aver_sat[i]) for i in range(len(counts))])


# ----------------------------------------------------------------------- UIQM


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _alpha_trimmed_mean(x: torch.Tensor, alpha_l=0.1, alpha_r=0.1) -> torch.Tensor:
    """(K, N) float32 -> (K,) float32, bem_tpu's off-by-one slice included."""
    n = x.shape[1]
    t_l, t_r = int(math.ceil(alpha_l * n)), int(math.floor(alpha_r * n))
    s = torch.sort(x, dim=1).values[:, t_l + 1:n - t_r].to(torch.float64).sum(dim=1)
    return _f32(s) / (n - t_l - t_r)


def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    return _f32(x.to(torch.float64).mean(dim=1))


def _uicm(x: torch.Tensor) -> torch.Tensor:
    k = x.shape[0]
    R, G, B = (x[..., c].reshape(k, -1) for c in range(3))
    rg = R - G
    yb = (R + G) / 2 - B
    mu_rg, mu_yb = _alpha_trimmed_mean(rg), _alpha_trimmed_mean(yb)
    s_rg = _mean_f32((rg - mu_rg[:, None]) ** 2)
    s_yb = _mean_f32((yb - mu_yb[:, None]) ** 2)
    mu_rg, mu_yb, s_rg, s_yb = (t.to(torch.float64) for t in (mu_rg, mu_yb, s_rg, s_yb))
    return (-0.0268 * torch.sqrt(mu_rg ** 2 + mu_yb ** 2)
            + 0.1586 * torch.sqrt(s_rg + s_yb))


def _sobel_mag(ch: torch.Tensor) -> torch.Tensor:
    """(K, H, W) float32 of integers -> the Sobel magnitude scaled to a max
    of 255 per image. The derivatives are exact integers, so the float64
    root rounded to float32 is hypotf's correctly rounded result."""
    p = torch.nn.functional.pad(ch[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    d0 = p[:, 2:, :] - p[:, :-2, :]  # derivative along rows
    d1 = p[:, :, 2:] - p[:, :, :-2]  # derivative along columns
    dx = d0[:, :, :-2] + 2 * d0[:, :, 1:-1] + d0[:, :, 2:]
    dy = d1[:, :-2, :] + 2 * d1[:, 1:-1, :] + d1[:, 2:, :]
    mag = _f32(torch.sqrt(dx.to(torch.float64) ** 2 + dy.to(torch.float64) ** 2))
    m = mag.amax(dim=(1, 2))
    scale = torch.where(m > 0, torch.tensor(255.0, device=m.device) / torch.where(
        m > 0, m, torch.ones_like(m)), torch.ones_like(m))
    return mag * scale[:, None, None]


def _block_ids(n: int, blocksize: int, nb: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) // blocksize, max=nb - 1)


def _eme(ch: torch.Tensor, blocksize: int = 10) -> torch.Tensor:
    """(K, H, W) float32 -> (K,) float64: block log(max / min), the remainder
    in the last block, blocks with a zero min or max skipped."""
    k, h, w = ch.shape
    nx, ny = h // blocksize, w // blocksize
    if nx == 0 or ny == 0:
        return torch.zeros(k, dtype=torch.float64, device=ch.device)
    ids = (_block_ids(h, blocksize, nx, ch.device)[:, None] * ny
           + _block_ids(w, blocksize, ny, ch.device)[None, :]).reshape(1, -1).expand(k, -1)
    flat = ch.reshape(k, -1)
    init = torch.zeros(k, nx * ny, dtype=ch.dtype, device=ch.device)
    bmax = init.scatter_reduce(1, ids, flat, "amax", include_self=False)
    bmin = init.scatter_reduce(1, ids, flat, "amin", include_self=False)
    ok = (bmin != 0) & (bmax != 0)
    wgt = float(np.float32(2.0 / (nx * ny)))  # bem_tpu's weight meets a float32 log
    term = torch.where(ok, wgt * torch.log(bmax / torch.where(ok, bmin, torch.ones_like(bmin))),
                       torch.zeros_like(bmin))
    return term.to(torch.float64).sum(dim=1)


def _uism(x: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for c, lam in enumerate(_UISM_LAMBDAS):
        ch = x[..., c]
        total = total + lam * _eme(_sobel_mag(ch) * ch)
    return total


def _uiconm(x: torch.Tensor, window_size: int = 10) -> torch.Tensor:
    k, h, w, _ = x.shape
    k1, k2 = w // window_size, h // window_size
    if k1 == 0 or k2 == 0:
        return torch.zeros(k, dtype=torch.float64, device=x.device)
    blocks = x[:, :k2 * window_size, :k1 * window_size, :].reshape(
        k, k2, window_size, k1, window_size, -1)
    bmax = blocks.amax(dim=(2, 4, 5))
    bmin = blocks.amin(dim=(2, 4, 5))
    top, bot = bmax - bmin, bmax + bmin
    ok = (bot != 0) & (top != 0)
    ratio = torch.where(ok, top / torch.where(bot == 0, torch.ones_like(bot), bot),
                        torch.zeros_like(bot))
    pos = ratio > 0
    term = torch.where(pos, ratio * torch.log(torch.where(pos, ratio, torch.ones_like(ratio))),
                       torch.zeros_like(ratio))
    s = _f32(term.reshape(k, -1).to(torch.float64).sum(dim=1))
    return (float(np.float32(-1.0 / (k1 * k2))) * s).to(torch.float64)


def uiqm_batch(rgb: torch.Tensor) -> np.ndarray:
    """UIQM of each uint8 RGB image of (K, H, W, 3), computed on the images'
    device; a float64 (K,) array."""
    x = rgb.to(torch.float32)
    c1, c2, c3 = _UIQM_COE
    return (c1 * _uicm(x) + c2 * _uism(x) + c3 * _uiconm(x, 10)).cpu().numpy()


def uiqm_uciqe_batch(cands: torch.Tensor):
    """The eval CLI's UIQM + UCIQE scores of (K, H, W, 3) float candidates in
    [0, 1], on their device: UIQM on each candidate rounded to uint8 and
    resized by Pillow's bicubic to (256, int(256 / W * H)), UCIQE on the
    full uint8 candidate. Returns two float64 numpy (K,) arrays."""
    u8 = (cands * 255).round().to(torch.uint8)
    h, w = u8.shape[1], u8.shape[2]
    small = pil_bicubic_resize_u8(u8, (256, int(256 / w * h)))
    return uiqm_batch(small), uciqe_batch(u8)


# ------------------------------------------------------------- single images


def getUCIQE(img_RGB) -> float:
    """(H, W, 3) RGB uint8 -> UCIQE."""
    return float(uciqe_batch(_as_batch(img_RGB))[0])


def getUIQM(img_RGB) -> float:
    """(H, W, 3) RGB uint8 -> UIQM."""
    return float(uiqm_batch(_as_batch(img_RGB))[0])


def _crop(img, crop_border):
    img = np.asarray(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return img


def calculate_uciqe(img, crop_border=0, input_order="HWC", **kwargs):
    """img: [0, 255] BGR (the metrics' convention) -> UCIQE."""
    return getUCIQE(_crop(img, crop_border)[..., ::-1].astype(np.uint8))


def calculate_uiqm(img, crop_border=0, input_order="HWC", **kwargs):
    """img: [0, 255] BGR -> UIQM."""
    return getUIQM(_crop(img, crop_border)[..., ::-1].astype(np.uint8))
