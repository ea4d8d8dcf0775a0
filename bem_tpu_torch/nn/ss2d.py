"""SS2D, the 2D selective-scan block, ``v05_noz`` fused-core form.

Counterpart of bem_tpu/nn/ss2d.py::SS2D on its fused branch
(ss2d.py:207-389): stem kernel (LN + in_proj + depthwise 3x3 + SiLU), the
row scan pair, the column scan pair, and the tail kernel (merge + LN +
out_proj + residual). The column pair takes bem_tpu's dispatch
(ss2d.py:335-358): where ``col_pair_supported(H, W)``, the transpose-free
column kernels merge the row pair's output and the tail reads one stream;
elsewhere the row pair's kernel runs on the transposed sequence. No bias
on in_proj, conv2d or out_proj. Other forward types raise
NotImplementedError. Every op is differentiable, so one module serves
training and serving.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.gdmlp_fused import stem_fused_cf
from ..ops.ss2d_seq import col_pair_supported, ss2d_col_pair, ss2d_seq_pair
from ..ops.ss2d_tail import ss2d_tail_cf
from . import init
from .layers import Conv2d, Dense, LayerNorm2d

K_DIRS = 4
# dt init range of the reference (vmamba.py:236-244)
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4


class SS2D(nn.Module):
    """The fused-core SS2D with the parameter tree of bem_tpu's SS2D."""

    def __init__(self, d_model: int, d_state: int = 1, ssm_ratio: float = 1.0,
                 forward_type: str = "v05_noz", bayesian: bool = False,
                 sigma_init: float = 0.05):
        super().__init__()
        if forward_type != "v05_noz":
            raise NotImplementedError(
                f"SS2D port: only forward_type='v05_noz' (got {forward_type!r})")
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.R = R = math.ceil(d_model / 16)  # dt_rank "auto"
        self.N = N = d_state
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.in_proj = Dense(d_model, d_inner, bias=False, **bayes)
        self.conv2d = Conv2d(d_inner, d_inner, 3, padding=1, groups=d_inner,
                             bias=False, **bayes)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * d_inner, N))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * d_inner))
        self.out_norm = LayerNorm2d(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=False, **bayes)

    @torch.no_grad()
    def reset_parameters(self, gen):
        fan_in, _ = init.jax_fans(tuple(self.x_proj_weight.shape))
        init.torch_default_(self.x_proj_weight, fan_in, gen)
        init.dt_proj_weight_(self.dt_projs_weight, self.R, gen)
        init.dt_proj_bias_(self.dt_projs_bias, gen, DT_MIN, DT_MAX, DT_INIT_FLOOR)
        init.a_log_(self.A_logs)
        self.Ds.fill_(1.0)

    def forward(self, x, hw, ln=None, residual: bool = False):
        """x: flat channel-first (B, d_model, H*W), hw=(H, W). ``ln`` =
        (weight, bias) folds the block's pre-LN into the stem; ``residual``
        adds x to the output inside the tail. Returns (B, d_model, H*W)."""
        B, _, L = x.shape
        H, W = hw
        C = self.d_inner
        w_in, b_in = self.in_proj.weights()
        k_cv, b_cv = self.conv2d.weights()
        lns, lnb = ln if ln is not None else (None, None)
        xs = stem_fused_cf(x, w_in, b_in, k_cv.reshape(C, 9), b_cv, H, W, lns, lnb)
        A = -torch.exp(self.A_logs.float()).reshape(K_DIRS, C, self.N)
        D = self.Ds.reshape(K_DIRS, C)
        w = (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias, A, D)
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
                            w_out.t(), b_out, x if residual else None)
