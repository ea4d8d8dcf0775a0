"""Layers and blocks of the port (counterpart of bem_tpu/nn)."""

from .layers import (BayesLayer, Conv2d, Dense, DropPath, LayerNorm2d, PReLU, drop_path,
                     dropout, dropout_mask, pixel_shuffle_cf, sample_bayes)
from .ss2d import SS2D
from .vss import FFNv02, GDMlp, GMlp, Mlp, VSSBlock
from .vssm import VSSM, BackboneVSSM, PatchMerging2D
