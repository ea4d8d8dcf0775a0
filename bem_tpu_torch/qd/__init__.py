"""The QD quaternion Retinex decomposition (counterpart of bem_tpu/qd):
the frozen ``Decomp`` networks the Decomp archs embed, and their shipped
checkpoints."""

from .convert import load_decomp_params
from .models import Q1_W_INDICES, Q2_W_INDICES, Decomp

__all__ = ["Decomp", "Q1_W_INDICES", "Q2_W_INDICES", "load_decomp_params"]
