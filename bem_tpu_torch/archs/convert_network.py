"""Reference PyTorch checkpoints -> bem_tpu's flax-layout params, for the
``Network`` (CG / IE U-Net) and the Decomp dual branch (counterpart of
bem_tpu/archs/convert_network.py); ``convert.load_flax_params`` then puts
the tree into the port's module.

Handles deterministic layers and the Bayesian ``mu_*`` / ``rho_*`` pairs,
PatchMerging / DualUpSample or conv / transposed-conv resampling, the four
MLP types (gdMlp, Mlp / gMlp ``fc1`` / ``fc2``, FFNv02 ``net.0`` / ``.2`` /
``.4``), a BasicBlock's ``sam_blocks.<i>``, the m0 SS2D's ``conv2d.1`` and
the SS2D out-norms held in the reference's ``get_outnorm`` Sequential
(``_oncnorm``: ``out_norm.0`` LN and ``out_norm.2`` conv -> ``out_norm`` /
``out_norm_conv``; ``_ondwconv3``: ``out_norm.1`` conv -> ``out_norm``).
bem_tpu's converter maps neither FFNv02, SAM nor those out-norms; their
reference key names here are the module paths of the reference's
``nn.Sequential`` / ``ModuleList`` layout, not yet checked against a
released checkpoint. A key the mapping needs and does not find raises
a KeyError; ``convert_network_checkpoint`` warns of the keys the
checkpoint has and the mapping left unused.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

import numpy as np

from ..utils.torch_convert import (assemble, conv_kernel, conv_transpose_kernel, linear_kernel,
                                   to_numpy, torch_load)


class _Mapper:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.out: Dict[str, np.ndarray] = {}
        self.used = set()

    def _get(self, key):
        self.used.add(key)
        return self.sd[key]

    def _pair(self, dst, src, kernel):
        """A layer's weight (or mu / rho pair) and bias through ``kernel``."""
        if f"{src}.mu_weight" in self.sd:
            for p in ("mu", "rho"):
                self.out[f"{dst}/{p}_kernel"] = kernel(self._get(f"{src}.{p}_weight"))
            if f"{src}.mu_bias" in self.sd:
                self.out[f"{dst}/mu_bias"] = self._get(f"{src}.mu_bias")
                self.out[f"{dst}/rho_bias"] = self._get(f"{src}.rho_bias")
            return
        self.out[f"{dst}/kernel"] = kernel(self._get(f"{src}.weight"))
        if f"{src}.bias" in self.sd:
            self.out[f"{dst}/bias"] = self._get(f"{src}.bias")

    def conv(self, dst, src):
        """Conv2d (or its Conv2dReparameterization twin)."""
        self._pair(dst, src, conv_kernel)

    def linear(self, dst, src):
        """Linear / Linear2d (or reparameterized)."""
        self._pair(dst, src, lambda w: linear_kernel(w.reshape(w.shape[0], -1)))

    def conv_t(self, dst, src):
        self.out[f"{dst}/kernel"] = conv_transpose_kernel(self._get(f"{src}.weight"))
        if f"{src}.bias" in self.sd:
            self.out[f"{dst}/bias"] = self._get(f"{src}.bias")

    def ln(self, dst, src):
        self.out[f"{dst}/scale"] = self._get(f"{src}.weight")
        self.out[f"{dst}/bias"] = self._get(f"{src}.bias")

    def prelu(self, dst, src):
        self.out[f"{dst}/slope"] = self._get(f"{src}.weight")

    def raw(self, dst, src):
        self.out[dst] = self._get(src)

    def has(self, src, *leaves):
        return any(f"{src}.{leaf}" in self.sd for leaf in leaves)


def _convert_ss2d(m: _Mapper, dst: str, src: str):
    m.linear(f"{dst}/in_proj", f"{src}.in_proj")
    if m.has(f"{src}.conv2d", "weight", "mu_weight"):
        m.conv(f"{dst}/conv2d", f"{src}.conv2d")
    elif m.has(f"{src}.conv2d.1", "weight"):
        # m0 wraps the conv in Sequential(Permute, Conv2d, Permute)
        m.conv(f"{dst}/conv2d", f"{src}.conv2d.1")
    m.raw(f"{dst}/x_proj_weight", f"{src}.x_proj_weight")
    if f"{src}.dt_projs_weight" in m.sd:  # absent in m0 (mamba2) modules
        m.raw(f"{dst}/dt_projs_weight", f"{src}.dt_projs_weight")
    m.raw(f"{dst}/dt_projs_bias", f"{src}.dt_projs_bias")
    m.raw(f"{dst}/A_logs", f"{src}.A_logs")
    m.raw(f"{dst}/Ds", f"{src}.Ds")
    if f"{src}.out_norm.weight" in m.sd:
        m.ln(f"{dst}/out_norm", f"{src}.out_norm")
    elif f"{src}.out_norm.2.weight" in m.sd:  # _oncnorm: LN, (permute,) dw conv
        m.ln(f"{dst}/out_norm", f"{src}.out_norm.0")
        m.conv(f"{dst}/out_norm_conv", f"{src}.out_norm.2")
    elif f"{src}.out_norm.1.weight" in m.sd:  # _ondwconv3: (permute,) dw conv
        m.conv(f"{dst}/out_norm", f"{src}.out_norm.1")
    m.linear(f"{dst}/out_proj", f"{src}.out_proj")


def _convert_vss_block(m: _Mapper, dst: str, src: str):
    m.ln(f"{dst}/norm", f"{src}.norm")
    _convert_ss2d(m, f"{dst}/op", f"{src}.op")
    if f"{src}.norm2.weight" in m.sd:
        m.ln(f"{dst}/norm2", f"{src}.norm2")
        if m.has(f"{src}.mlp.project_in", "weight", "mu_weight"):  # gdMlp
            for part in ("project_in", "dwconv", "project_out"):
                m.conv(f"{dst}/mlp/{part}", f"{src}.mlp.{part}")
        elif m.has(f"{src}.mlp.net.0", "weight", "mu_weight"):  # FFNv02's Sequential
            for i in (0, 2, 4):
                m.conv(f"{dst}/mlp/net_{i}", f"{src}.mlp.net.{i}")
        else:  # Mlp / gMlp
            m.linear(f"{dst}/mlp/fc1", f"{src}.mlp.fc1")
            m.linear(f"{dst}/mlp/fc2", f"{src}.mlp.fc2")


def _convert_sam(m: _Mapper, dst: str, src: str):
    """SAM: three dilated dense blocks (``conv_layers.<j>.conv.0``, the
    Conv2d of each conv + ReLU Sequential, and ``conv_post.conv.0``) and the
    CSAF fusion's three 1x1 convs."""
    for blk in ("basic_block", "basic_block_2", "basic_block_4"):
        j = 0
        while f"{src}.{blk}.conv_layers.{j}.conv.0.weight" in m.sd:
            conv = f"{src}.{blk}.conv_layers.{j}.conv.0"
            m.out[f"{dst}/{blk}/conv{j}_kernel"] = conv_kernel(m._get(f"{conv}.weight"))
            m.out[f"{dst}/{blk}/conv{j}_bias"] = m._get(f"{conv}.bias")
            j += 1
        m.conv(f"{dst}/{blk}/conv_post", f"{src}.{blk}.conv_post.conv.0")
    for part in ("compress1", "compress2", "excitation"):
        m.conv(f"{dst}/fusion/{part}", f"{src}.fusion.{part}")


def _convert_dual_upsample(m: _Mapper, dst: str, src: str):
    for branch in ("p", "b"):
        m.conv(f"{dst}/up_{branch}_conv1", f"{src}.up_{branch}.0")
        m.prelu(f"{dst}/up_{branch}_prelu", f"{src}.up_{branch}.1")
        m.conv(f"{dst}/up_{branch}_conv2", f"{src}.up_{branch}.3")
    m.conv(f"{dst}/conv", f"{src}.conv")


def _network_mapper(sd, num_blocks=(2, 2, 2), stage=1, use_pixelshuffle=True) -> _Mapper:
    m = _Mapper(sd)
    m.out["mask_token"] = m._get("mask_token").transpose(0, 2, 3, 1)
    m.conv("first_conv", "first_conv")
    m.conv("proj", "proj")
    levels = len(num_blocks) - 1

    def blocks(dst, src, nb):
        for b in range(nb):
            _convert_vss_block(m, f"{dst}/blocks_{b}", f"{src}.blocks.{b}")
            if m.has(f"{src}.sam_blocks.{b}.fusion.compress1", "weight"):
                _convert_sam(m, f"{dst}/sam_blocks_{b}", f"{src}.sam_blocks.{b}")

    for s in range(stage):
        base, dstb = f"subnets.{s}", f"subnets_{s}"
        for i in range(levels):
            blocks(f"{dstb}/enc_{i}", f"{base}.encoder_layers.{i}.0", num_blocks[i])
            down = f"{base}.encoder_layers.{i}.1"
            if use_pixelshuffle:  # PatchMerging
                m.ln(f"{dstb}/down_{i}/norm", f"{down}.norm")
                m.conv(f"{dstb}/down_{i}/reduction", f"{down}.reduction")
            else:
                m.conv(f"{dstb}/down_{i}/conv", down)
        blocks(f"{dstb}/bottleneck", f"{base}.bottleneck", num_blocks[-1])
        # decoder_layers.{i} is ModuleList([up, fusion_conv, block])
        for i in range(levels):
            up = f"{base}.decoder_layers.{i}.0"
            if use_pixelshuffle:
                _convert_dual_upsample(m, f"{dstb}/up_{i}", up)
            else:
                m.conv_t(f"{dstb}/up_{i}/deconv", up)
            m.conv(f"{dstb}/fusion_{i}", f"{base}.decoder_layers.{i}.1")
            blocks(f"{dstb}/dec_{i}", f"{base}.decoder_layers.{i}.2", num_blocks[levels - 1 - i])
    return m


def convert_network_state(sd: Dict[str, np.ndarray], num_blocks=(2, 2, 2), stage: int = 1,
                          use_pixelshuffle: bool = True) -> Dict[str, Any]:
    """Reference ``Network`` state_dict (numpy) -> bem_tpu's flax params."""
    return assemble(_network_mapper(sd, num_blocks, stage, use_pixelshuffle).out)


def _dualbranch_mapper(sd, num_blocks) -> _Mapper:
    m = _Mapper(sd)
    levels = len(num_blocks) - 1

    def level(dst, src, nb):
        for b in range(nb):
            _convert_vss_block(m, f"{dst}/block_{b}", f"{src}.{b}")

    for tag in ("Q1", "Q2"):
        m.conv(f"branches/first_conv_{tag}", f"first_conv_{tag}")
        for i in range(levels):
            level(f"branches/enc_{tag}_{i}", f"encoders_{tag}.{i}", num_blocks[i])
            m.conv(f"branches/down_{tag}_{i}", f"down_layers_{tag}.{i}")
    m.conv("branches/bottleneck_fuse", "bottleneck_fuse")
    level("branches/bottleneck", "bottleneck_block", num_blocks[-1])
    m.conv("branches/bottleneck_to_Q1", "bottleneck_to_Q1")
    m.conv("branches/bottleneck_to_Q2", "bottleneck_to_Q2")
    for tag in ("Q1", "Q2"):
        for i in range(levels):
            m.conv_t(f"branches/up_{tag}_{i}", f"decoders_{tag}.{i}.up")
            m.conv(f"branches/fuse_{tag}_{i}", f"decoders_{tag}.{i}.fuse")
            level(f"branches/dec_{tag}_{i}", f"decoders_{tag}.{i}.block",
                  num_blocks[levels - 1 - i])
        m.conv(f"branches/proj_{tag}", f"proj_{tag}")
    return m


def convert_dualbranch_state(sd: Dict[str, np.ndarray], num_blocks=(2, 2, 2)) -> Dict[str, Any]:
    """Reference DecompDualBranchDDWavelet / DecompDualBranch2 branch weights
    -> the flax params of the ``branches`` subtree; the frozen ``decomp.*``
    keys are left alone (the arch's ``load_frozen`` puts them in)."""
    return assemble(_dualbranch_mapper(sd, num_blocks).out)


def convert_network_checkpoint(path: str, param_key: str = "params", **kwargs) -> Dict[str, Any]:
    """A reference ``Network`` ``ckpt.pth`` -> bem_tpu's flax params: its
    ``param_key`` entry (else the object itself) through
    ``convert_network_state``."""
    obj = torch_load(path)
    sd = to_numpy(obj[param_key] if param_key in obj else obj)
    m = _network_mapper(sd, **kwargs)
    unused = sorted(set(sd) - m.used)
    if unused:
        warnings.warn(f"{path}: {len(unused)} checkpoint keys unused by the mapping: "
                      f"{unused[:20]}{' ...' if len(unused) > 20 else ''}")
    return assemble(m.out)
