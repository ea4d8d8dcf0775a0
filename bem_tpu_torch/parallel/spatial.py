"""Row-sharded (sequence-parallel) inference of a whole ``Network``.

Counterpart of bem_tpu/parallel/spatial.py. bem_tpu shards the image rows
over a mesh axis and lets XLA's SPMD partitioner insert the halo
exchanges and the scan's distributed prefix. Here each rank holds one band
of rows, (B, H/n, W, C), from the input to the output, and
:func:`spatial_apply` binds a band form to every module of the net that
looks past its own rows:

- every convolution with a kernel taller than 1 (first_conv, proj, the
  SS2D stem's and the gdMlp's depthwise 3x3s, ConvDown): the rows it needs
  from the neighbouring bands come from one all-gather of each band's
  boundary rows; the zero pad stays at the image's top and bottom only;
- DualUpSample's bilinear x2 (half-pixel centres): one halo row each
  side, the edge row repeated only at the image's top and bottom, where
  the unsharded upsample clamps;
- the SS2D's 4-direction core, row 8 (``ss2d_dir_fused``, unclamped):
  the row-major sequence of the image is the concatenation of the row
  bands, and after an all-to-all from row bands to column bands the
  column-major one is the concatenation of the column bands, so one
  launch a rank scans ``stack(row band, column band transposed)`` at
  L = H*W/n. The four directions' states entering each rank's chunks then
  follow parallel/context.py: each chunk's summaries exp(A * sum dt) and
  its end state from 0 (a weighted sum over the chunk in plain torch: the
  kernel returns no states) are all-gathered and scanned exclusively over
  the ranks (the forward directions from the rank before, the reverse ones
  from the rank after), and C_t (exp(A * cumsum dt)_t * carry_in) is added
  to y. The column pair goes back to row bands by a second all-to-all.
  The state exchanged is O(B * 4 * C * N) a block besides the transposes.
  Where n does not divide a level's width the column bands are uneven
  (the all-to-all takes split sizes); the shorter of a rank's two chunks
  is padded with zero input, which keeps a zero state at zero, and its
  summaries are taken at its real end.

PatchMerging, the pixel shuffle, the 1x1 convs, LayerNorm and the
activations act on each row alone. No rank gathers the image.

As bem_tpu asks, the net is built with ``scan_backend="xla"`` (asserted)
and H divides by n * 2^levels. Modules with a reduction over the whole
image (SAM, the "softmax" out-norm) or windows are refused.
"""

from __future__ import annotations

import contextlib
import types
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..archs.arch_util import ConvDown, DeconvUp, DualUpSample, PatchMerging
from ..archs.unet_arch import BasicBlock, Network, SubNetwork
from ..nn.layers import (Conv2d, ConvTranspose2d, Dense, DropPath, LayerNorm2d, PReLU)
from ..nn.ss2d import SS2D
from ..nn.vss import FFNv02, GDMlp, GMlp, Mlp, VSSBlock
from ..ops._common import softplus
from ..ops.ss2d_fused import ss2d_dir_fused
from .context import exclusive_carry
from .mesh import Mesh

# module types whose forward acts on each row alone, or which hold the
# band forms below
_ROW_LOCAL = (Network, SubNetwork, BasicBlock, VSSBlock, SS2D, Conv2d, ConvTranspose2d, Dense,
              LayerNorm2d, PatchMerging, DualUpSample, ConvDown, DeconvUp, PReLU, DropPath, GDMlp,
              Mlp, GMlp, FFNv02)


class SpatialSharding(NamedTuple):
    """NHWC with the image rows split over ``axis``."""
    mesh: Mesh
    axis: str


def spatial_sharding(mesh: Mesh, axis: str = "space") -> SpatialSharding:
    return SpatialSharding(mesh, axis)


# ------------------------------------------------------------------- halos
def halo_rows(mesh: Mesh, x: torch.Tensor, top: int, bottom: int):
    """(the ``top`` rows above this rank's band, the ``bottom`` rows below
    it), each None at the image's edge, for a (B, C, h, W) band: one
    all-gather of every band's first ``bottom`` and last ``top`` rows."""
    if mesh.size == 1 or top + bottom == 0:
        return None, None
    h = x.shape[2]
    if max(top, bottom) > h:
        raise ValueError(f"a halo of {max(top, bottom)} rows over a band of {h}")
    edges = mesh.all_gather(torch.cat([x[:, :, :bottom], x[:, :, h - top:]], 2))
    r = mesh.rank
    above = edges[r - 1][:, :, bottom:] if r > 0 and top else None
    below = edges[r + 1][:, :, :bottom] if r < mesh.size - 1 and bottom else None
    return above, below


def _upsample_band(t: torch.Tensor, scale: int, mesh: Mesh) -> torch.Tensor:
    """This rank's band of the bilinear upsample (half-pixel centres) of
    the whole image by an integer ``scale``, for a (B, C, h, W) band: one
    row from each neighbour, the edge row itself at the image's top and
    bottom (the upsample's clamp)."""
    above, below = halo_rows(mesh, t, 1, 1)
    tt = torch.cat([t[:, :, :1] if above is None else above, t,
                    t[:, :, -1:] if below is None else below], 2)
    y = F.interpolate(tt, scale_factor=scale, mode="bilinear", align_corners=False)
    return y[:, :, scale:-scale]


def upsample_rows(x: torch.Tensor, scale: int, mesh: Mesh) -> torch.Tensor:
    """``ops.resize.resize_bilinear`` of the whole image by an integer
    ``scale`` on this rank's (B, h, W, C) band: (B, h * scale, W * scale, C)."""
    return _upsample_band(x.permute(0, 3, 1, 2), scale, mesh).permute(0, 2, 3, 1).contiguous()


def _conv_band(mesh):
    def forward(self, x):
        """Conv2d on a band: the rows above and below from the neighbours,
        zeros at the image's edges, no row padding in the conv itself."""
        w, b = self.weights()
        k, p, s = w.shape[2], self.padding, self.stride
        top, bottom = p, k - s - p
        above, below = halo_rows(mesh, x, top, bottom)
        zeros = x.new_zeros(x.shape[0], x.shape[1], 1, x.shape[3])
        parts = [above if above is not None else zeros.expand(-1, -1, top, -1), x,
                 below if below is not None else zeros.expand(-1, -1, bottom, -1)]
        return F.conv2d(torch.cat(parts, 2), w.to(x.dtype),
                        None if b is None else b.to(x.dtype), s, (0, p), 1, self.groups)
    return forward


# ------------------------------------------------------- the SS2D core, row 8
def _chunk_terms(x, Wx, Wdt, bias, A, reverse: bool):
    """One direction over one rank's chunk x (B, C, L) fp32: (decay
    exp(A sum dt) (B, C, N), the end state from 0 (B, C, N), the readout
    rows C_t (B, N, L), and the log-decay from each position to the chunk's
    start edge in scan order, inclusive (B, C, L): the carry's weight is
    exp(A * it))."""
    N, R = A.shape[-1], Wdt.shape[-1]
    xd = torch.einsum("pc,bcl->bpl", Wx, x)
    dt = softplus(torch.einsum("cr,brl->bcl", Wdt, xd[:, :R]) + bias[None, :, None])
    Bt = xd[:, R:R + N]
    Ct = xd[:, R + N:]
    pre = dt.cumsum(-1)                                     # sum over s <= t
    suf = dt.flip(-1).cumsum(-1).flip(-1)                   # sum over s >= t
    # the decay from position t to the chunk's end in scan order, exclusive
    to_end = (pre if reverse else suf) - dt
    from_start = suf if reverse else pre
    decay = torch.exp(dt.sum(-1)[..., None] * A)            # (B, C, N)
    w = torch.exp(to_end[..., None] * A[None, :, None])     # (B, C, L, N)
    end = torch.einsum("bcln,bnl->bcn", w * (dt * x)[..., None], Bt)
    return decay, end, Ct, from_start


def _core_band(mesh):
    def dir_core(self, xs):
        """The 4-direction core on a (B, C, h, W) band: y_row + y_col of the
        band's rows, (B, C, h, W) fp32 (see the module docstring)."""
        B, C, h, W = xs.shape
        n, r = mesh.size, mesh.rank
        H = h * n
        widths = [W // n + (j < W % n) for j in range(n)]
        starts = [sum(widths[:j]) for j in range(n)]
        wr = widths[r]
        bands = mesh.all_to_all([xs[..., s:s + w] for s, w in zip(starts, widths)],
                                [(B, C, h, wr)] * n)
        col = torch.cat(bands, 2).transpose(2, 3).reshape(B, C, wr * H)
        row = xs.reshape(B, C, h * W)
        lens = (h * W, wr * H)
        L = max(lens)
        xs2 = torch.stack([F.pad(row, (0, L - lens[0])), F.pad(col, (0, L - lens[1]))], 1)
        Wx, Wdt, bias, A, D = (t.detach().float() for t in self._scan_weights())
        y2 = ss2d_dir_fused(xs2.contiguous(), Wx, Wdt, bias, A, D, clamp=False)
        # per direction k = s + 2 d (stream s, reverse d): its chunk's terms
        terms = {}
        for s in (0, 1):
            x = xs2[:, s, :, :lens[s]].float()
            for d in (0, 1):
                k = s + 2 * d
                terms[k] = _chunk_terms(x, Wx[k], Wdt[k], bias[k], A[k], bool(d))
        summaries = mesh.all_gather(torch.stack([torch.stack([terms[k][i] for k in range(4)], 1)
                                                 for i in (0, 1)]))  # (decays, ends) by rank
        decays, ends = [t[0] for t in summaries], [t[1] for t in summaries]
        ys = []
        for s in (0, 1):
            corr = 0.0
            for d in (0, 1):
                k = s + 2 * d
                carry = exclusive_carry([t[:, k] for t in decays], [t[:, k] for t in ends],
                                        reverse=bool(d))[r]                      # (B, C, N)
                _, _, Ct, from_start = terms[k]
                wgt = torch.exp(from_start[..., None] * A[k][None, :, None])     # (B, C, L, N)
                corr = corr + torch.einsum("bcln,bcn,bnl->bcl", wgt, carry, Ct)
            ys.append((y2[:, s, :, :lens[s]].float() + corr).to(xs.dtype))
        y_row = ys[0].reshape(B, C, h, W)
        back = ys[1].reshape(B, C, wr, H).transpose(2, 3)                        # (B, C, H, wr)
        parts = mesh.all_to_all([back[:, :, i * h:(i + 1) * h] for i in range(n)],
                                [(B, C, h, w) for w in widths])
        return (y_row + torch.cat(parts, 3)).float()
    return dir_core


# ------------------------------------------------------------------ binding
def _check(net, n: int, h: int):
    backend = getattr(net, "scan_backend", None)
    if backend != "xla":
        raise AssertionError(
            "spatial_apply requires the network to be built with scan_backend='xla' (got "
            f"{backend!r}), as bem_tpu's does: the fused serving kernels take whole images")
    for name, m in net.named_modules():
        if not isinstance(m, _ROW_LOCAL):
            raise NotImplementedError(f"spatial_apply: {name} ({type(m).__name__}) has no "
                                      f"row-sharded form")
        if isinstance(m, VSSBlock) and m.grid_size:
            raise NotImplementedError(f"spatial_apply: {name} runs windows (grid_size)")
        if isinstance(m, SS2D) and (m.m0 or m.scans != 0 or m.flags["out_norm"] == "softmax"):
            raise NotImplementedError(f"spatial_apply: {name} is not the 4-direction core "
                                      f"with a per-pixel out-norm")
        if isinstance(m, SubNetwork) and h % (2 ** m.level):
            raise ValueError(f"spatial_apply: H = {h * n} over {n} ranks leaves bands of {h} "
                             f"rows, which {m.level} levels of 2x down-sampling do not divide "
                             f"(H must divide by n * 2^levels)")


@contextlib.contextmanager
def _bound(net, mesh: Mesh):
    """The band forms bound to the net's modules for the duration."""
    bound = []
    for m in net.modules():
        if isinstance(m, Conv2d) and (m.value("weight").shape[2] > 1 or m.stride > 1):
            bound.append((m, "forward", types.MethodType(_conv_band(mesh), m)))
        elif isinstance(m, DualUpSample):
            bound.append((m, "upsample2", lambda t: _upsample_band(t, 2, mesh)))
        elif isinstance(m, SS2D):
            bound.append((m, "_dir_core", types.MethodType(_core_band(mesh), m)))
    try:
        for m, attr, fn in bound:
            setattr(m, attr, fn)
        yield
    finally:
        for m, attr, _ in bound:
            delattr(m, attr)


@torch.no_grad()
def spatial_apply(net, x: torch.Tensor, mesh: Mesh, axis: str = "space",
                  params: Optional[dict] = None) -> torch.Tensor:
    """This rank's band of ``net(x)[-1]`` for the whole image, x being this
    rank's (B, H/n, W, C) band of it (rank order = row order). The mesh
    has one axis: ``axis``, bem_tpu's choice among several, is its name
    there and is not read. ``params``
    overrides the net's parameters for the call (``torch.func.functional_call``;
    e.g. a Bayesian weight sample, the same on every rank). Returns (B,
    H/n, W, out_channels). ``mesh`` may be a :class:`SpatialSharding`."""
    if isinstance(mesh, SpatialSharding):
        mesh = mesh.mesh
    _check(net, mesh.size, x.shape[1])
    with _bound(net, mesh):
        return functional_call(net, params or {}, (x,))[-1]
