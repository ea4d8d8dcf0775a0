"""VSSBlock and its MLPs (gdMlp, Mlp, gMlp, FFNv02), channel-first.

Counterpart of bem_tpu/nn/vss.py. The BEM nets' block (gdMlp, the
``v05_noz`` fused core, no drop-path) runs ``x = x + SS2D(LN(x))`` and
``x = x + gdMlp(LN2(x))`` with both LNs and both residual adds folded into
the kernels (vss.py:256-299): the stem and tail kernels for the SS2D
branch, the gdMlp kernel for the MLP branch. Every other block (a drop
path, another core or another MLP) runs the unfolded pre-norm form
``x + drop_path(op(norm(x)))``, ``x + drop_path(mlp(norm2(x)))``
(vss.py:265-299) on (B, C, H, W); bem_tpu runs it channels-last, the math
is the same. Each MLP carries bem_tpu's ``bayesian`` / ``sigma_init``: its
convs and linears then hold (mu, rho) pairs.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..ops.gdmlp_fused import gdmlp_fused_cf
from .layers import Conv2d, Dense, DropPath, LayerNorm2d
from .ss2d import SS2D


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 over the channel axis (vss.py:105)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.fc1 = Dense(in_features, hidden_features, **bayes)
        self.fc2 = Dense(hidden_features, out_features, **bayes)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class GMlp(nn.Module):
    """fc1 to 2*hidden -> x * GELU(z) -> fc2 (vss.py:119)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.fc1 = Dense(in_features, 2 * hidden_features, **bayes)
        self.fc2 = Dense(hidden_features, out_features, **bayes)

    def forward(self, x):
        x, z = self.fc1(x).chunk(2, dim=1)
        return self.fc2(x * F.gelu(z))


class FFNv02(nn.Module):
    """1x1 -> GELU -> depthwise 3x3 -> GELU -> 1x1, no biases (vss.py:133)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 bayesian: bool = False, sigma_init: float = 0.05):
        super().__init__()
        h = hidden_features
        bayes = dict(bias=False, bayesian=bayesian, sigma_init=sigma_init)
        self.net_0 = Conv2d(in_features, h, 1, **bayes)
        self.net_2 = Conv2d(h, h, 3, padding=1, groups=h, **bayes)
        self.net_4 = Conv2d(h, out_features, 1, **bayes)

    def forward(self, x):
        return self.net_4(F.gelu(self.net_2(F.gelu(self.net_0(x)))))


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

    def forward(self, x, hw=None, ln=None, residual: bool = False):
        """x (B, C, H*W) flat channel-first with hw=(H, W) -> (B, out_features,
        H*W); or a (B, C, H, W) map -> (B, out_features, H, W), the unfolded
        block's form (no LN, no residual)."""
        if x.dim() == 4:
            B, C, H, W = x.shape
            out = self(x.reshape(B, C, H * W).contiguous(), (H, W))
            return out.reshape(B, -1, H, W)
        k_in, b_in = self.project_in.weights()
        k_dw, b_dw = self.dwconv.weights()
        k_out, b_out = self.project_out.weights()
        lns, lnb = ln if ln is not None else (None, None)
        return gdmlp_fused_cf(
            x, k_in.reshape(k_in.shape[0], -1), b_in, k_dw.reshape(k_dw.shape[0], 9),
            b_dw, k_out.reshape(k_out.shape[0], -1), b_out, hw[0], hw[1], lns, lnb,
            residual)


_MLPS = {"gdmlp": GDMlp, "mlp": Mlp, "gmlp": GMlp, "ffnv02": FFNv02}


class VSSBlock(nn.Module):
    """The reference VSSBlock, pre-norm and non-windowed. ``mlp_type``
    "gdmlp" is the BEM form, folded into the kernels where the block has the
    v05_noz core with its 3x3 stem and no drop-path; "mlp" / "gmlp" /
    "ffnv02" and every other gdMlp block run unfolded."""

    def __init__(self, hidden_dim: int, ssm_d_state: int = 1,
                 ssm_ratio: float = 1.0, mlp_ratio: float = 4.0,
                 bayesian: bool = False, sigma_init: float = 0.05,
                 drop_path: float = 0.0, ssm_dt_rank="auto", ssm_conv: int = 3,
                 ssm_conv_bias: bool = False, forward_type: str = "v05_noz",
                 mlp_type: str = "gdmlp"):
        super().__init__()
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.norm = LayerNorm2d(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                       forward_type=forward_type, dt_rank=ssm_dt_rank, d_conv=ssm_conv,
                       conv_bias=ssm_conv_bias, **bayes)
        self.fold = (mlp_type == "gdmlp" and not drop_path and self.op.fused_core
                     and ssm_conv == 3)
        if mlp_ratio > 0:
            self.norm2 = LayerNorm2d(hidden_dim)
            self.mlp = _MLPS[mlp_type](hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim,
                                       **bayes)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, gen=None):
        """x (B, C, H, W) -> (B, C, H, W). ``gen`` (a torch.Generator)
        turns drop-path on (training); without it the block is deterministic."""
        B, C, H, W = x.shape
        if not self.fold:
            x = x + self.drop_path(self.op(self.norm(x)), gen)
            if hasattr(self, "mlp"):
                x = x + self.drop_path(self.mlp(self.norm2(x)), gen)
            return x
        # the BEM form: the interior runs on (B, C, H*W)
        x = x.reshape(B, C, H * W).contiguous()
        x = self.op(x, (H, W), (self.norm.weight, self.norm.bias), residual=True)
        if hasattr(self, "mlp"):
            x = self.mlp(x, (H, W), (self.norm2.weight, self.norm2.bias), residual=True)
        return x.reshape(B, C, H, W)
