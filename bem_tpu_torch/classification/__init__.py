"""The VMamba classification harness (counterpart of bem_tpu/classification)."""

from .config import CfgNode, get_config, vmamba_tiny
from .train import (build_model_from_config, cross_entropy, make_trainer, synthetic_batch,
                    throughput, train_one_epoch, validate, warmup_cosine_decay_schedule)
