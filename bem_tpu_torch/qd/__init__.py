"""The QD quaternion Retinex decomposition (counterpart of bem_tpu/qd): the
``Decomp`` networks the Decomp archs embed frozen and their shipped
checkpoints, the compact two-branch variant, the Retinex loss, the paired
dataset, the trainer (``qd.train``), the RCI and the evaluator
(``qd.evaluate``)."""

from .convert import load_decomp_params
from .decomp import CompactTwoBranchModel
from .loss import RetinexLoss, frequency_regularization, total_variation_loss
from .models import Q1_W_INDICES, Q2_W_INDICES, Decomp

__all__ = ["CompactTwoBranchModel", "Decomp", "Q1_W_INDICES", "Q2_W_INDICES", "RetinexLoss",
           "frequency_regularization", "load_decomp_params", "total_variation_loss"]
