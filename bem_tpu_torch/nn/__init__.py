"""Layers and blocks of the port (counterpart of bem_tpu/nn)."""

from .layers import (BayesLayer, Conv2d, Dense, LayerNorm2d, PReLU,
                     pixel_shuffle_cf, sample_bayes)
from .ss2d import SS2D
from .vss import GDMlp, VSSBlock
