"""SS2D, the 2D selective-scan block, with bem_tpu's dispatch (ss2d.py:166-737).

Counterpart of bem_tpu/nn/ss2d.py::SS2D for every forward type it
implements, in bem_tpu's Pallas-backend dispatch, channel-first where
bem_tpu runs NHWC (the same math):

- **Fused core** (ss2d.py:217-389), for scans 0 with no z gate (``_noz``),
  no ``_oact`` and the LayerNorm out-norm: the row scan pair, the column
  scan pair and the tail kernel (merge + LN + out_proj). The column pair
  takes bem_tpu's dispatch (ss2d.py:335-358): where
  ``col_pair_supported(H, W)``, the transpose-free column kernels merge
  the row pair's output; elsewhere the row pair's kernel runs on the
  transposed sequence. On the flat channel-first stream (B, d_model, H*W)
  of the BEM nets, the stem kernel also folds the block's pre-LN,
  in_proj, the depthwise 3x3 and SiLU, and the tail kernel the residual
  (not while dropout runs: it acts between out_proj and the add); on a
  (B, d_model, H, W) map the stem is unfused.
- **The 4-direction fused core** (ss2d.py:440-482) for scans 0 otherwise:
  unfused stem (in_proj with the z split, SiLU on z, depthwise conv with
  ``conv_bias``, SiLU), xs2 = (row, column) sequences, :func:`ss2d_dir_fused` -- clamped
  where ``pick_group(B, d_inner) > 1``, as bem_tpu takes the grouped
  kernel there -- then y_row + y_col in fp32.
- **The scan-pattern forward types** (ss2d.py:483-541), scans 1 (``v051d``,
  four row-major scans) and 2 (``v052d``, row-major forward twice and
  reversed twice): the unfused stem, :func:`cross_scan_cf_input`, the x
  and dt projections as two einsums in the stream dtype,
  :func:`selective_scan_fused` (its output in the stream dtype),
  :func:`cross_merge_cf_output` in that dtype.
- **cascade2d** (``v052dc``, scans 3, ss2d.py:390-439): a parameterless
  LN of the stem output, the bidirectional row scan (directions 0-1),
  cast to the stream dtype and LN'd, then the bidirectional column scan
  (directions 2-3), each on :func:`selective_scan` (fp32 out; its
  recurrence is ``linear_scan``, kernel 7). The reversed direction's
  output is summed position by position without being flipped back, as
  bem_tpu does (ss2d.py:429).
- **m0** (mamba2 / SSD, ss2d.py:614-737): K * R heads of width d_inner /
  R on :func:`ssd_chunk_scan` (plain tensor code, no kernel), the
  activation ``act_layer`` ("gelu" is the tanh approximation, as
  jax.nn.gelu's default), an optional initial-state buffer.

``scan_backend`` is bem_tpu's field (ss2d.py:136, read at :210). ``None``
and ``"pallas"`` take the dispatch above. ``"xla"`` and ``"ref"`` take
bem_tpu's XLA composition (ss2d.py:483 onwards), which neither fuses the
serving core nor clamps: scans 0 run the 4-direction core unclamped (row 8
with ``clamp=False`` on the card) at every batch, whatever the input's
forward-type flags; the other scan modes keep their routes, which do not
clamp either.

Then the out-norm (``ln``, ``none``, ``dwconv3``, ``cnorm``, ``softmax``
over each channel's positions, ``sigmoid``; ss2d.py:573-598), the cast to
the input dtype, ``_oact``'s exact GELU, ``y * z`` and out_proj, then
dropout (ss2d.py:604-607), its keep mask drawn from the caller's
generator or given. The SSM inits ``v0`` (mamba's dt / A / D), ``v1`` and
``v2`` (ss2d.py:284-295; m0's at :658-666) come from
:meth:`SS2D.reset_parameters`. Every op is differentiable, so one module
serves training and inference.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cross_scan import cross_merge_cf_output, cross_scan_cf_input
from ..ops.gdmlp_fused import stem_fused_cf
from ..ops.scan import selective_scan
from ..ops.scan_fused import selective_scan_fused
from ..ops.ss2d_fused import pick_group, ss2d_dir_fused
from ..ops.ss2d_seq import col_pair_supported, ss2d_col_pair, ss2d_seq_pair
from ..ops.ss2d_tail import ss2d_tail_cf
from ..ops.ssd import ssd_chunk_scan
from . import init
from .layers import Conv2d, Dense, LayerNorm2d, dropout

K_DIRS = 4
# dt init range of the reference (vmamba.py:236-244)
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
# forward-type bases and their scan mode (ss2d.py:88-94): cross2d (0),
# unidi (1), bidi (2), cascade2d (3); m0 has a forward of its own
SCAN_MODES = {"v01": 0, "v02": 0, "v03": 0, "v04": 0, "v05": 0, "v2": 0, "v0": 0, "v0seq": 0,
              "v051d": 1, "v052d": 2, "v052dc": 3}
OUT_NORMS = ("ln", "none", "dwconv3", "cnorm", "softmax", "sigmoid")
# bem_tpu's scan backends (ops/scan.py:61): None is its default, Pallas on
# the TPU; the port's kernels take the Pallas routes
SCAN_BACKENDS = (None, "pallas", "xla", "ref")
ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh")}


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


def _plain_ln(t):
    """LN over the last axis without affine, statistics in fp32, cast back
    (ss2d.py:397-401)."""
    tf = t.float()
    m = tf.mean(-1, keepdim=True)
    v = (tf - m).square().mean(-1, keepdim=True)
    return ((tf - m) * torch.rsqrt(v + 1e-5)).to(t.dtype)


def _dwconv3(C: int) -> Conv2d:
    return Conv2d(C, C, 3, padding=1, groups=C, bias=False)


class SS2D(nn.Module):
    """SS2D with the parameter tree of bem_tpu's SS2D (see the module
    docstring). ``dropout`` is the rate after out_proj, ``initialize`` the
    SSM init ("v0", "v1", "v2"); ``chunk_size``, ``with_initial_state`` and
    ``act_layer`` are m0's; ``scan_backend`` selects bem_tpu's route (None,
    "pallas", "xla" or "ref")."""

    def __init__(self, d_model: int, d_state: int = 1, ssm_ratio: float = 1.0,
                 forward_type: str = "v05_noz", bayesian: bool = False,
                 sigma_init: float = 0.05, dt_rank="auto", d_conv: int = 3,
                 conv_bias: bool = False, bias: bool = False, dropout: float = 0.0,
                 initialize: str = "v0", chunk_size: int = 64,
                 with_initial_state: bool = False, act_layer: str = "silu",
                 scan_backend=None):
        super().__init__()
        if scan_backend not in SCAN_BACKENDS:
            raise ValueError(f"SS2D: scan_backend {scan_backend!r} ({SCAN_BACKENDS})")
        base, flags = parse_forward_type(forward_type)
        self.m0 = base.startswith("m")
        if base not in SCAN_MODES and base != "m0":
            raise NotImplementedError(f"forward_type base {base!r}")
        if initialize not in ("v0", "v1", "v2"):
            raise ValueError(f"SS2D: initialize {initialize!r} (v0, v1 or v2)")
        if act_layer not in ACTS:
            raise ValueError(f"SS2D: act_layer {act_layer!r} ({tuple(ACTS)})")
        self.flags, self.dropout, self.initialize = flags, dropout, initialize
        # the XLA composition neither fuses the core nor clamps (ss2d.py:213-218)
        self.xla = scan_backend in ("xla", "ref")
        self.chunk_size, self.act_layer = chunk_size, act_layer
        self.scans = None if self.m0 else SCAN_MODES[base]
        # bem_tpu takes the fused serving core only for the cross2d scan with
        # the LayerNorm out-norm (ss2d.py:217-220), and the 4-direction core
        # for the cross2d scan otherwise (ss2d.py:440)
        self.fused_core = (self.scans == 0 and flags["noz"] and not flags["oact"]
                           and flags["out_norm"] == "ln" and not self.xla)
        self.d_inner = d_inner = int(ssm_ratio * d_model)
        self.R = R = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        self.N = N = d_state
        if self.m0 and d_inner % R:
            raise ValueError(f"d_inner {d_inner} not divisible by dt_rank {R}")
        bayes = dict(bayesian=bayesian, sigma_init=sigma_init)
        d_proj = d_inner if flags["noz"] else 2 * d_inner
        self.in_proj = Dense(d_model, d_proj, bias=bias, **bayes)
        self.conv2d = (Conv2d(d_inner, d_inner, d_conv, padding=(d_conv - 1) // 2,
                              groups=d_inner, bias=conv_bias, **bayes) if d_conv > 1 else None)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, d_inner))
        if self.m0:  # heads K * R of width Dh; no dt projection (ss2d.py:655-666)
            self.Dh = d_inner // R
            self.A_logs = nn.Parameter(torch.empty(K_DIRS, R))
            self.Ds = nn.Parameter(torch.empty(K_DIRS, R, self.Dh))
            self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, R))
            if with_initial_state:  # bem_tpu's "ssm_state" collection
                self.register_buffer("initial_state",
                                     torch.zeros(1, K_DIRS * R, self.Dh, N))
        else:
            self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, R))
            self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
            self.A_logs = nn.Parameter(torch.empty(K_DIRS * d_inner, N))
            self.Ds = nn.Parameter(torch.empty(K_DIRS * d_inner))
        on = flags["out_norm"]
        if on in ("ln", "cnorm"):
            self.out_norm = LayerNorm2d(d_inner)
        elif on == "dwconv3":
            self.out_norm = _dwconv3(d_inner)
        if on == "cnorm":
            self.out_norm_conv = _dwconv3(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=bias, **bayes)

    @torch.no_grad()
    def reset_parameters(self, gen):
        fan_in, _ = init.jax_fans(tuple(self.x_proj_weight.shape))
        init.torch_default_(self.x_proj_weight, fan_in, gen)
        self.Ds.fill_(1.0)
        if self.m0:  # ss2d.py:658-663: v0 and v1 draw, v2 zeroes A
            if self.initialize == "v2":
                self.A_logs.zero_()
                init.uniform01_(self.dt_projs_bias, 0.1, gen)
            else:
                init.normal_(self.A_logs, 1.0, gen)
                init.normal_(self.dt_projs_bias, 0.1, gen)
            if hasattr(self, "initial_state"):
                self.initial_state.zero_()
        elif self.initialize == "v0":
            init.dt_proj_weight_(self.dt_projs_weight, self.R, gen)
            init.dt_proj_bias_(self.dt_projs_bias, gen, DT_MIN, DT_MAX, DT_INIT_FLOOR)
            init.a_log_(self.A_logs)
        elif self.initialize == "v1":  # ss2d.py:289-295
            init.normal_(self.dt_projs_weight, 0.1, gen)
            init.normal_(self.dt_projs_bias, 0.1, gen)
            init.normal_(self.A_logs, 1.0, gen)
        else:
            init.uniform01_(self.dt_projs_weight, 0.1, gen)
            init.uniform01_(self.dt_projs_bias, 0.1, gen)
            self.A_logs.zero_()

    def _scan_weights(self):
        C = self.d_inner
        A = -torch.exp(self.A_logs.float()).reshape(K_DIRS, C, self.N)
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias, A,
                self.Ds.reshape(K_DIRS, C))

    def _stem(self, x, act=F.silu):
        """Unfused stem on a (B, d_model, H, W) map: (xs, z or None)."""
        xz = self.in_proj(x)
        z = None
        if not self.flags["noz"]:
            xz, z = xz.chunk(2, dim=1)
            if not self.flags["nozact"]:
                z = act(z)
        if self.conv2d is not None:
            xz = self.conv2d(xz)
        return act(xz), z

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

    def _dir_core(self, xs):
        """The 4-direction fused core (ss2d.py:440-482) on the stem's (B, C,
        H, W) output: y_row + y_col, (B, C, H, W) fp32. A method, so that a
        row-sharded forward (parallel/spatial.py) can bind its band form."""
        B, C, H, W = xs.shape
        L = H * W
        xs2 = torch.stack([xs.reshape(B, C, L), xs.transpose(2, 3).reshape(B, C, L)], 1)
        y2 = ss2d_dir_fused(xs2.contiguous(), *self._scan_weights(),
                            clamp=not self.xla and pick_group(B, C) > 1)
        return (y2[:, 0].reshape(B, C, H, W)
                + y2[:, 1].reshape(B, C, W, H).transpose(2, 3)).float()

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

    def _scan_rowcol(self, t, k0: int, rows: bool):
        """One bidirectional scan of cascade2d (ss2d.py:403-434) over t (B, H,
        W, C): along the rows (directions 0-1) or the columns (2-3); the two
        directions' outputs summed position by position. fp32 out."""
        B, H, W, C = t.shape
        R, N, dtype = self.R, self.N, t.dtype
        seq = t.reshape(B * H, W, C) if rows else t.transpose(1, 2).reshape(B * W, H, C)
        M, Lr = seq.shape[:2]
        xs2 = torch.stack([seq, seq.flip(1)], 1)                            # (M, 2, L, C)
        x_dbl = torch.einsum("mkld,kcd->mklc", xs2, self.x_proj_weight[k0:k0 + 2].to(dtype))
        dts2 = torch.einsum("mklr,kdr->mkld", x_dbl[..., :R],
                            self.dt_projs_weight[k0:k0 + 2].to(dtype))
        A = -torch.exp(self.A_logs.float()).reshape(K_DIRS, C, N)[k0:k0 + 2].reshape(-1, N)
        y2 = selective_scan(
            xs2.transpose(1, 2).reshape(M, Lr, 2 * C), dts2.transpose(1, 2).reshape(M, Lr, 2 * C),
            A, x_dbl[..., R:R + N].transpose(1, 2), x_dbl[..., R + N:].transpose(1, 2),
            D=self.Ds.reshape(K_DIRS, C)[k0:k0 + 2].reshape(-1),
            delta_bias=self.dt_projs_bias[k0:k0 + 2].reshape(-1))
        y = y2.reshape(M, Lr, 2, C).sum(2)  # the reversed direction stays unflipped
        return y.reshape(B, H, W, C) if rows else y.reshape(B, W, H, C).transpose(1, 2)

    def _cascade(self, xs):
        """cascade2d (ss2d.py:390-439) on the stem's (B, C, H, W) output,
        run channels-last as bem_tpu runs it: (B, C, H, W) fp32."""
        y_row = _plain_ln(self._scan_rowcol(_plain_ln(xs.permute(0, 2, 3, 1)), 0, True)
                          .to(xs.dtype))
        return self._scan_rowcol(y_row, 2, False).permute(0, 3, 1, 2)

    def _out_norm(self, y):
        """The out-norm (ss2d.py:573-595) on a (B, C, H, W) map."""
        on = self.flags["out_norm"]
        if on in ("ln", "dwconv3"):
            return self.out_norm(y)
        if on == "cnorm":
            return self.out_norm_conv(self.out_norm(y))
        if on == "softmax":  # over each channel's positions
            return y.reshape(*y.shape[:2], -1).softmax(-1).reshape(y.shape)
        if on == "sigmoid":
            return torch.sigmoid(y)
        return y

    def _head(self, y, z, dtype):
        """Out-norm, cast to ``dtype``, _oact, gate and out_proj (ss2d.py:573-603)."""
        y = self._out_norm(y).to(dtype)
        if self.flags["oact"]:
            y = F.gelu(y)
        if z is not None:
            y = y * z
        return self.out_proj(y)

    def _forward_m0(self, x, update_state: bool):
        """mamba2 / SSD (ss2d.py:614-737) on a (B, d_model, H, W) map."""
        B, _, H, W = x.shape
        K, R, N, Dh, L = K_DIRS, self.R, self.N, self.Dh, x.shape[2] * x.shape[3]
        xs, z = self._stem(x, ACTS[self.act_layer])
        dtype = xs.dtype
        seqs = cross_scan_cf_input(xs, 0)                               # (B, K, C, L)
        x_dbl = torch.einsum("bkcl,krc->bklr", seqs, self.x_proj_weight.to(dtype))
        init_state = None
        if hasattr(self, "initial_state"):
            init_state = self.initial_state.expand(B, -1, -1, -1)
        ys, final_state = ssd_chunk_scan(
            seqs.permute(0, 3, 1, 2).reshape(B, L, K * R, Dh),
            x_dbl[..., :R].transpose(1, 2).reshape(B, L, K * R),
            -torch.exp(self.A_logs.float()).reshape(K * R),
            x_dbl[..., R:R + N].transpose(1, 2), x_dbl[..., R + N:].transpose(1, 2),
            self.chunk_size, D=self.Ds.float().reshape(K * R, Dh),
            dt_bias=self.dt_projs_bias.float().reshape(K * R), initial_states=init_state,
            dt_softplus=True, return_final_states=True)
        if init_state is not None and update_state:  # bem_tpu's mutable=["ssm_state"]
            with torch.no_grad():
                self.initial_state.copy_(final_state.sum(0, keepdim=True))
        ys = ys.reshape(B, L, K, self.d_inner).permute(0, 2, 3, 1)       # (B, K, C, L)
        return self._head(cross_merge_cf_output(ys, H, W, 0), z, x.dtype)

    def forward(self, x, hw=None, ln=None, residual: bool = False, gen=None, drop_mask=None,
                update_state: bool = False):
        """x: flat channel-first (B, d_model, H*W) with hw=(H, W), the BEM
        nets' stream (fused core only: ``ln`` = (weight, bias) folds the
        block's pre-LN into the stem kernel and ``residual`` adds x inside
        the tail; returns (B, d_model, H*W)), or a (B, d_model, H, W) map
        (returns the same shape). ``gen`` (a torch.Generator) or
        ``drop_mask`` (bool, the output's shape) turns dropout on;
        ``update_state`` writes m0's initial-state buffer with the batch sum
        of the final state."""
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
            if not self.dropout or (gen is None and drop_mask is None):
                return self._pairs_and_tail(xs, H, W, x if residual else None)
            # dropout runs between out_proj and the add: the residual leaves the tail
            out = dropout(self._pairs_and_tail(xs, H, W), self.dropout, gen, drop_mask)
            return out + x if residual else out
        if ln is not None or residual:
            raise NotImplementedError("SS2D port: ln / residual fold only on the flat stream")
        if self.m0:
            return dropout(self._forward_m0(x, update_state), self.dropout, gen, drop_mask)
        B, _, H, W = x.shape
        L = H * W
        C = self.d_inner
        xs, z = self._stem(x)
        if self.fused_core:
            out = self._pairs_and_tail(xs.reshape(B, C, L).contiguous(), H, W).reshape(B, -1, H, W)
        else:
            if self.scans == 0:
                y = self._dir_core(xs)
            elif self.scans == 3:
                y = self._cascade(xs)
            else:
                y = self._scan_patterns(xs, H, W)
            out = self._head(y, z, x.dtype)
        return dropout(out, self.dropout, gen, drop_mask)
