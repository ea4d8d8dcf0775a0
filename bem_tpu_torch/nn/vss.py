"""VSSBlock and its MLPs (gdMlp, Mlp, gMlp, FFNv02), channel-first.

Counterpart of bem_tpu/nn/vss.py. The BEM nets' block (gdMlp, the
``v05_noz`` fused core, no drop-path) runs ``x = x + SS2D(LN(x))`` and
``x = x + gdMlp(LN2(x))`` with both LNs and both residual adds folded into
the kernels (vss.py:256-299): the stem and tail kernels for the SS2D
branch, the gdMlp kernel for the MLP branch (while the SS2D's dropout
runs, its residual add leaves the tail, as bem_tpu's does). Every other
block (a drop path, another core or MLP, post-norm, windows) runs the
unfolded form on (B, C, H, W); bem_tpu runs it channels-last, the math is
the same. Each MLP carries bem_tpu's ``bayesian`` / ``sigma_init``: its
convs and linears then hold (mu, rho) pairs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.gdmlp_fused import gdmlp_fused_cf
from .layers import Conv2d, Dense, DropPath, LayerNorm2d, dropout_mask
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
    """1x1 -> dw3x3 -> chunk -> GELU(x1)*x2 -> 1x1, as one kernel call; with
    ``fused=False`` as three convs, each rounding its output to the stream
    dtype (bem_tpu's NHWC route, vss.py:96-102)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 bayesian: bool = False, sigma_init: float = 0.05, fused: bool = True):
        super().__init__()
        self.fused = fused
        h = hidden_features
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.project_in = Conv2d(in_features, 2 * h, 1, **bayes)
        self.dwconv = Conv2d(2 * h, 2 * h, 3, padding=1, groups=2 * h, **bayes)
        self.project_out = Conv2d(h, out_features, 1, **bayes)

    def forward(self, x, hw=None, ln=None, residual: bool = False):
        """x (B, C, H*W) flat channel-first with hw=(H, W) -> (B, out_features,
        H*W); or a (B, C, H, W) map -> (B, out_features, H, W), the unfolded
        block's form (no LN, no residual)."""
        if not self.fused:
            x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
            return self.project_out(F.gelu(x1) * x2)
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
    """The reference VSSBlock (vss.py:166-302). ``mlp_type`` "gdmlp" is the
    BEM form, folded into the kernels where the block has the v05_noz core
    with its 3x3 stem, no drop-path, no post-norm and no windows; every
    other block runs unfolded, pre-norm ``x + drop_path(op(norm(x)))`` or,
    with ``post_norm``, ``x + drop_path(norm(op(x)))`` (and the same for the
    MLP). ``grid_size`` runs the SS2D per window (zero-padded bottom and
    right to a multiple, then cropped); ``use_checkpoint`` recomputes each
    branch in the backward (torch.utils.checkpoint). ``ssm_drop_rate`` and
    ``ssm_init`` are the SS2D's dropout and init; ``mlp_drop_rate`` is
    accepted and unused, as in bem_tpu (vss.py:178). ``ssm_ratio`` 0 drops
    the SS2D branch, ``mlp_ratio`` 0 the MLP's. ``scan_backend`` "xla" /
    "ref" takes bem_tpu's XLA route (vss.py:185): the SS2D's unfused stem
    and unclamped core, and the gdMlp as three convs, so the block runs
    unfolded."""

    def __init__(self, hidden_dim: int, ssm_d_state: int = 1,
                 ssm_ratio: float = 1.0, mlp_ratio: float = 4.0,
                 bayesian: bool = False, sigma_init: float = 0.05,
                 drop_path: float = 0.0, ssm_dt_rank="auto", ssm_conv: int = 3,
                 ssm_conv_bias: bool = False, forward_type: str = "v05_noz",
                 mlp_type: str = "gdmlp", ssm_drop_rate: float = 0.0, ssm_init: str = "v0",
                 mlp_drop_rate: float = 0.0, post_norm: bool = False, grid_size=None,
                 use_checkpoint: bool = False, scan_backend=None):
        super().__init__()
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        self.post_norm, self.grid_size, self.use_checkpoint = post_norm, grid_size, use_checkpoint
        self.fold = False
        if ssm_ratio > 0:
            self.norm = LayerNorm2d(hidden_dim)
            self.op = SS2D(hidden_dim, d_state=ssm_d_state, ssm_ratio=ssm_ratio,
                           forward_type=forward_type, dt_rank=ssm_dt_rank, d_conv=ssm_conv,
                           conv_bias=ssm_conv_bias, dropout=ssm_drop_rate, initialize=ssm_init,
                           scan_backend=scan_backend, **bayes)
            self.fold = (mlp_type == "gdmlp" and not drop_path and self.op.fused_core
                         and ssm_conv == 3 and not post_norm and not grid_size)
        if mlp_ratio > 0:
            self.norm2 = LayerNorm2d(hidden_dim)
            if mlp_type == "gdmlp":
                bayes["fused"] = scan_backend not in ("xla", "ref")
            self.mlp = _MLPS[mlp_type](hidden_dim, int(hidden_dim * mlp_ratio), hidden_dim,
                                       **bayes)
        self.drop_path = DropPath(drop_path)

    def _op_shape(self, x):
        """The SS2D output's shape for the block input x: the windows' where
        ``grid_size`` is set."""
        B, C, H, W = x.shape
        ws = self.grid_size
        if not ws:
            return x.shape
        return (B * -(-H // ws) * -(-W // ws), C, ws, ws)

    def draw_masks(self, x, gen=None, masks=None) -> dict:
        """The block's keep masks: ``masks`` (injected) completed with draws
        from ``gen``: "ssm" (the SS2D dropout's, bool of the SS2D output's
        shape), "path" and "path2" (the two branches' drop-path, (B,) bool).
        Drawn before either branch runs, so a recomputed branch sees them."""
        m = dict(masks or {})
        if gen is None:
            return m
        if hasattr(self, "op") and self.op.dropout > 0 and "ssm" not in m:
            m["ssm"] = dropout_mask(self._op_shape(x), self.op.dropout, gen)
        if self.drop_path.rate > 0:
            for k in ("path", "path2"):
                if k not in m:
                    m[k] = dropout_mask((x.shape[0],), self.drop_path.rate, gen)
        return m

    def _ckpt(self, fn, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _run_op(self, h, mask):
        """The SS2D on h (B, C, H, W), per window where ``grid_size`` is set
        (vss.py:241-254)."""
        ws = self.grid_size
        if not ws:
            return self.op(h, drop_mask=mask)
        B, C, H, W = h.shape
        hp = F.pad(h, (0, -W % ws, 0, -H % ws))
        nh, nw = hp.shape[2] // ws, hp.shape[3] // ws
        wins = hp.reshape(B, C, nh, ws, nw, ws).permute(0, 2, 4, 1, 3, 5).reshape(-1, C, ws, ws)
        out = self.op(wins, drop_mask=mask).reshape(B, nh, nw, C, ws, ws)
        return out.permute(0, 3, 1, 4, 2, 5).reshape(B, C, nh * ws, nw * ws)[:, :, :H, :W]

    def _ssm_branch(self, x, mask):
        if self.post_norm:
            return self.norm(self._run_op(x, mask))
        return self._run_op(self.norm(x), mask)

    def _mlp_branch(self, x):
        return self.norm2(self.mlp(x)) if self.post_norm else self.mlp(self.norm2(x))

    def _folded_ssm(self, x, H, W, mask):
        return self.op(x, (H, W), (self.norm.weight, self.norm.bias), residual=True,
                       drop_mask=mask)

    def _folded_mlp(self, x, H, W):
        return self.mlp(x, (H, W), (self.norm2.weight, self.norm2.bias), residual=True)

    def forward(self, x, gen=None, masks=None):
        """x (B, C, H, W) -> (B, C, H, W). ``gen`` (a torch.Generator) turns
        drop-path and dropout on (training), drawing what ``masks`` (see
        :meth:`draw_masks`) does not give; with neither the block is
        deterministic."""
        B, C, H, W = x.shape
        m = self.draw_masks(x, gen, masks)
        if self.fold:  # the BEM form: the interior runs on (B, C, H*W)
            mask = m.get("ssm")
            x = self._ckpt(self._folded_ssm, x.reshape(B, C, H * W).contiguous(), H, W,
                           None if mask is None else mask.reshape(B, C, H * W))
            if hasattr(self, "mlp"):
                x = self._ckpt(self._folded_mlp, x, H, W)
            return x.reshape(B, C, H, W)
        if hasattr(self, "op"):
            x = x + self.drop_path(self._ckpt(self._ssm_branch, x, m.get("ssm")),
                                   mask=m.get("path"))
        if hasattr(self, "mlp"):
            x = x + self.drop_path(self._ckpt(self._mlp_branch, x), mask=m.get("path2"))
        return x
