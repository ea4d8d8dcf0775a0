"""VSSBlock and its gated-dconv MLP (gdMlp), channel-first.

Counterpart of bem_tpu/nn/vss.py. Each block runs
``x = x + SS2D(LN(x))`` and ``x = x + gdMlp(LN2(x))`` with both LNs and
both residual adds folded into the kernels (vss.py:256-299): the stem and
tail kernels for the SS2D branch, the gdMlp kernel for the MLP branch.
"""

from __future__ import annotations

from torch import nn

from ..ops.gdmlp_fused import gdmlp_fused_cf
from .layers import Conv2d, LayerNorm2d
from .ss2d import SS2D


class GDMlp(nn.Module):
    """1x1 -> dw3x3 -> chunk -> GELU(x1)*x2 -> 1x1, as one kernel call."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        h = hidden_features
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.project_in = Conv2d(in_features, 2 * h, 1, **bayes)
        self.dwconv = Conv2d(2 * h, 2 * h, 3, padding=1, groups=2 * h, **bayes)
        self.project_out = Conv2d(h, out_features, 1, **bayes)

    def forward(self, x, hw, ln=None, residual: bool = False):
        """x (B, C, H*W) flat channel-first -> (B, out_features, H*W)."""
        k_in, b_in = self.project_in.weights()
        k_dw, b_dw = self.dwconv.weights()
        k_out, b_out = self.project_out.weights()
        lns, lnb = ln if ln is not None else (None, None)
        return gdmlp_fused_cf(
            x, k_in.reshape(k_in.shape[0], -1), b_in, k_dw.reshape(k_dw.shape[0], 9),
            b_dw, k_out.reshape(k_out.shape[0], -1), b_out, hw[0], hw[1], lns, lnb,
            residual)


class VSSBlock(nn.Module):
    """The BEM configuration of the reference VSSBlock: v05_noz SS2D +
    gdMlp, pre-norm, no drop-path."""

    def __init__(self, hidden_dim: int, ssm_d_state: int = 1,
                 ssm_ratio: float = 1.0, mlp_ratio: float = 4.0,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.norm = LayerNorm2d(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio, **bayes)
        self.norm2 = LayerNorm2d(hidden_dim)
        self.mlp = GDMlp(hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim, **bayes)

    def forward(self, x):
        """x (B, C, H, W) -> (B, C, H, W); the interior runs on (B, C, H*W)."""
        B, C, H, W = x.shape
        x = x.reshape(B, C, H * W).contiguous()
        x = self.op(x, (H, W), (self.norm.weight, self.norm.bias), residual=True)
        x = self.mlp(x, (H, W), (self.norm2.weight, self.norm2.bias), residual=True)
        return x.reshape(B, C, H, W)
