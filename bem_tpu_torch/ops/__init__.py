"""Kernel-level functions of the port: each wraps a hand-written CUDA kernel
and carries its plain PyTorch version (used for CPU tensors)."""

from .cross_scan import (cross_merge_cf, cross_merge_cf_output, cross_scan_cf,
                         cross_scan_cf_input)
from .gdmlp_fused import (gdmlp_fused_cf, gdmlp_fused_cf_plain, stem_fused_cf,
                          stem_fused_cf_plain)
from .resize import resize_bilinear
from .scan import linear_scan, linear_scan_plain
from .scan_fused import selective_scan_fused, selective_scan_fused_plain
from .ss2d_fused import (ss2d_dir_fused, ss2d_dir_fused_bwd, ss2d_dir_fused_bwd_plain,
                         ss2d_dir_fused_g, ss2d_dir_fused_g_plain, ss2d_dir_fused_plain)
from .ss2d_seq import (col_pair_supported, ss2d_col_pair, ss2d_col_pair_plain,
                       ss2d_seq_pair, ss2d_seq_pair_plain)
from .ss2d_tail import ss2d_tail_cf, ss2d_tail_cf_plain
