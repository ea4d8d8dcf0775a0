"""SS2D, the 2D selective-scan block, with bem_tpu's dispatch (ss2d.py:207-612).

Counterpart of bem_tpu/nn/ss2d.py::SS2D for the cross2d forward types
(scans 0: v01-v05, v2, v0) and the unidi / bidi ones (scans 1, 2: v051d,
v052d) with the LayerNorm out-norm, in bem_tpu's Pallas-backend dispatch:

- **Fused core** (ss2d.py:217-389), for scans 0 where there is no z gate
  (``_noz``) and no ``_oact``: the row scan pair, the column scan pair and
  the tail kernel (merge + LN + out_proj). The column pair takes bem_tpu's dispatch
  (ss2d.py:335-358): where ``col_pair_supported(H, W)``, the transpose-free
  column kernels merge the row pair's output; elsewhere the row pair's
  kernel runs on the transposed sequence. On the flat channel-first stream
  (B, d_model, H*W) of the BEM nets, the stem kernel also folds the block's
  pre-LN, in_proj, the depthwise 3x3 and SiLU, and the tail kernel the
  residual; on a (B, d_model, H, W) map (bem_tpu's NHWC form, run
  channel-first here) the stem is unfused.
- **The 4-direction fused core** (ss2d.py:440-482) for scans 0 otherwise:
  unfused stem (in_proj with the z split, SiLU on z, depthwise conv with
  ``conv_bias``, SiLU), xs2 = (row, column) sequences, :func:`ss2d_dir_fused` -- clamped
  where ``pick_group(B, d_inner) > 1``, as bem_tpu takes the grouped
  kernel there -- then y_row + y_col, LayerNorm, the cast to the input
  dtype, ``y * z`` and out_proj (ss2d.py:573-612).
- **The scan-pattern forward types** (ss2d.py:483-541), scans 1 (``v051d``,
  four row-major scans) and 2 (``v052d``, row-major forward twice and
  reversed twice), with or without the z gate: the unfused stem,
  :func:`cross_scan_cf_input`, the x and dt projections as two einsums in
  the stream dtype, :func:`selective_scan_fused` (its output in the stream
  dtype), :func:`cross_merge_cf_output` in that dtype, then the same tail.

Other out-norms, ``v052dc`` (cascade2d), m0 and the windowed form raise
NotImplementedError; dropout and the v1 / v2 simple inits are not ported
(the classifier's config refuses them).
Every op is differentiable, so one module serves training and inference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cross_scan import cross_merge_cf_output, cross_scan_cf_input
from ..ops.gdmlp_fused import stem_fused_cf
from ..ops.scan_fused import selective_scan_fused
from ..ops.ss2d_fused import pick_group, ss2d_dir_fused
from ..ops.ss2d_seq import col_pair_supported, ss2d_col_pair, ss2d_seq_pair
from ..ops.ss2d_tail import ss2d_tail_cf
from . import init
from .layers import Conv2d, Dense, LayerNorm2d

K_DIRS = 4
# dt init range of the reference (vmamba.py:236-244)
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
# forward-type bases and their scan mode (ss2d.py:88-94): cross2d (0),
# unidi (1), bidi (2); cascade2d (v052dc, 3) is not ported
SCAN_MODES = {"v01": 0, "v02": 0, "v03": 0, "v04": 0, "v05": 0, "v2": 0, "v0": 0, "v0seq": 0,
              "v051d": 1, "v052d": 2}


def parse_forward_type(forward_type: str):
    """Split a reference forward_type string into (base, flags dict)
    (bem_tpu/nn/ss2d.py:55-85)."""
    flags = {"no32": False, "oact": False, "noz": False, "nozact": False, "out_norm": "ln"}
    out_norm_tags = (("_onnone", "none"), ("_ondwconv3", "dwconv3"), ("_oncnorm", "cnorm"),
                     ("_onsoftmax", "softmax"), ("_onsigmoid", "sigmoid"))
    changed = True
    while changed:
        changed = False
        for tag in ("_no32", "_oact", "_nozact", "_noz"):
            if forward_type.endswith(tag):
                flags[tag[1:]] = True
                forward_type = forward_type[: -len(tag)]
                changed = True
        for tag, name in out_norm_tags:
            if forward_type.endswith(tag):
                flags["out_norm"] = name
                forward_type = forward_type[: -len(tag)]
                changed = True
    return forward_type, flags


class SS2D(nn.Module):
    """SS2D with the parameter tree of bem_tpu's SS2D (see the module docstring)."""

    def __init__(self, d_model: int, d_state: int = 1, ssm_ratio: float = 1.0,
                 forward_type: str = "v05_noz", bayesian: bool = False,
                 sigma_init: float = 0.05, dt_rank="auto", d_conv: int = 3,
                 conv_bias: bool = False, bias: bool = False):
        super().__init__()
        base, flags = parse_forward_type(forward_type)
        if base == "v052dc":
            raise NotImplementedError("SS2D port: v052dc (cascade2d) is not ported yet "
                                      "(ROADMAP.md, modules still missing)")
        if base not in SCAN_MODES or flags["out_norm"] != "ln":
            raise NotImplementedError(
                f"SS2D port: forward_type {forward_type!r} (only the bases "
                f"{tuple(SCAN_MODES)} with the LayerNorm out-norm are ported)")
        self.flags = flags
        self.scans = SCAN_MODES[base]
        # bem_tpu takes the fused serving core only for the cross2d scan
        # (ss2d.py:217), and the 4-direction core likewise (ss2d.py:440)
        self.fused_core = self.scans == 0 and flags["noz"] and not flags["oact"]
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.R = R = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        self.N = N = d_state
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        d_proj = d_inner if flags["noz"] else 2 * d_inner
        self.in_proj = Dense(d_model, d_proj, bias=bias, **bayes)
        self.conv2d = (Conv2d(d_inner, d_inner, d_conv, padding=(d_conv - 1) // 2,
                              groups=d_inner, bias=conv_bias, **bayes) if d_conv > 1 else None)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * d_inner, N))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * d_inner))
        self.out_norm = LayerNorm2d(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=bias, **bayes)

    @torch.no_grad()
    def reset_parameters(self, gen):
        fan_in, _ = init.jax_fans(tuple(self.x_proj_weight.shape))
        init.torch_default_(self.x_proj_weight, fan_in, gen)
        init.dt_proj_weight_(self.dt_projs_weight, self.R, gen)
        init.dt_proj_bias_(self.dt_projs_bias, gen, DT_MIN, DT_MAX, DT_INIT_FLOOR)
        init.a_log_(self.A_logs)
        self.Ds.fill_(1.0)

    def _scan_weights(self):
        C = self.d_inner
        A = -torch.exp(self.A_logs.float()).reshape(K_DIRS, C, self.N)
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias, A,
                self.Ds.reshape(K_DIRS, C))

    def _stem(self, x):
        """Unfused stem on a (B, d_model, H, W) map: (xs, z or None)."""
        xz = self.in_proj(x)
        z = None
        if not self.flags["noz"]:
            xz, z = xz.chunk(2, dim=1)
            if not self.flags["nozact"]:
                z = F.silu(z)
        if self.conv2d is not None:
            xz = self.conv2d(xz)
        return F.silu(xz), z

    def _pairs_and_tail(self, xs, H, W, res=None):
        """The fused core from the stem's flat output (B, d_inner, H*W)."""
        B, C, L = xs.shape
        w = self._scan_weights()
        y_row = ss2d_seq_pair(xs, *w, "row")
        if col_pair_supported(H, W):
            # the column kernels walk the row-major stream and merge y_row
            y_row, y_colT = ss2d_col_pair(xs, *w, y_row, H, W), None
        else:
            # the column pair scans the transposed (column-major) sequence
            col = xs.reshape(B, C, H, W).transpose(2, 3).contiguous().reshape(B, C, L)
            y_col = ss2d_seq_pair(col, *w, "col")
            y_colT = y_col.reshape(B, C, W, H).transpose(2, 3).contiguous().reshape(B, C, L)
        w_out, b_out = self.out_proj.weights()
        return ss2d_tail_cf(y_row, y_colT, self.out_norm.weight, self.out_norm.bias,
                            w_out.t(), b_out, res)

    def _scan_patterns(self, xs, H, W):
        """The unidi / bidi core (ss2d.py:483-541) on the stem's (B, C, H, W)
        output: (B, C, H, W) in the stream dtype."""
        R, N, dtype = self.R, self.N, xs.dtype
        seqs = cross_scan_cf_input(xs, self.scans)                      # (B, K, C, L)
        x_dbl = torch.einsum("bkcl,krc->bkrl", seqs, self.x_proj_weight.to(dtype))
        dts = torch.einsum("bkrl,kdr->bkdl", x_dbl[:, :, :R], self.dt_projs_weight.to(dtype))
        ys = selective_scan_fused(
            seqs, dts.contiguous(), -torch.exp(self.A_logs.float()),
            x_dbl[:, :, R:R + N].contiguous(), x_dbl[:, :, R + N:].contiguous(),
            D=self.Ds, delta_bias=self.dt_projs_bias.reshape(-1))
        return cross_merge_cf_output(ys, H, W, self.scans)

    def forward(self, x, hw=None, ln=None, residual: bool = False):
        """x: flat channel-first (B, d_model, H*W) with hw=(H, W), the BEM
        nets' stream (fused core only: ``ln`` = (weight, bias) folds the
        block's pre-LN into the stem kernel and ``residual`` adds x inside
        the tail; returns (B, d_model, H*W)), or a (B, d_model, H, W) map
        (returns the same shape)."""
        if x.dim() == 3:
            if not self.fused_core or self.conv2d is None or self.conv2d.padding != 1:
                raise NotImplementedError("SS2D port: the flat stream needs the fused "
                                          "core's 3x3 stem")
            H, W = hw
            C = self.d_inner
            w_in, b_in = self.in_proj.weights()
            k_cv, b_cv = self.conv2d.weights()
            lns, lnb = ln if ln is not None else (None, None)
            xs = stem_fused_cf(x, w_in, b_in, k_cv.reshape(C, 9), b_cv, H, W, lns, lnb)
            return self._pairs_and_tail(xs, H, W, x if residual else None)
        if ln is not None or residual:
            raise NotImplementedError("SS2D port: ln / residual fold only on the flat stream")
        B, _, H, W = x.shape
        L = H * W
        xs, z = self._stem(x)
        if self.fused_core:
            out = self._pairs_and_tail(xs.reshape(B, self.d_inner, L).contiguous(), H, W)
            return out.reshape(B, -1, H, W)
        C = self.d_inner
        if self.scans == 0:  # the 4-direction fused core (ss2d.py:440-482)
            xs2 = torch.stack([xs.reshape(B, C, L), xs.transpose(2, 3).reshape(B, C, L)], 1)
            y2 = ss2d_dir_fused(xs2.contiguous(), *self._scan_weights(),
                                clamp=pick_group(B, C) > 1)
            y_row = y2[:, 0].reshape(B, C, H, W)
            y_col = y2[:, 1].reshape(B, C, W, H).transpose(2, 3)
            y = (y_row + y_col).float()
        else:
            y = self._scan_patterns(xs, H, W)
        y = self.out_norm(y).to(x.dtype)
        if self.flags["oact"]:
            y = F.gelu(y)
        if z is not None:
            y = y * z
        return self.out_proj(y)
