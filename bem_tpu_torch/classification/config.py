"""The classification harness's config tree, without yaml.

Counterpart of bem_tpu/classification/config.py (reference
basicsr/vmamba/config.py): a dict subclass with attribute access, clone
and ``merge_from_list``, and the default tree field for field
(bem_tpu/classification/config.py:121-233). ``KEY VALUE`` overrides parse
with ``ast.literal_eval`` (bem_tpu uses yaml, which the card's machine
lacks); the command line and ``--cfg`` YAML files are not ported yet.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List


class CfgNode(dict):
    """yacs.config.CfgNode lookalike: a nested dict with attribute access."""

    def __init__(self, init_dict=None):
        super().__init__()
        for k, v in (init_dict or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        c = CfgNode()
        for k, v in self.items():
            c[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return c

    def merge_from_list(self, opts: List[str]):
        """['TRAIN.BASE_LR', '1e-3', ...] pairs (vmamba/main.py --opts)."""
        if len(opts) % 2:
            raise ValueError(f"merge_from_list: odd number of items {opts}")
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(val, node.get(parts[-1]))


def _coerce(val: str, like: Any) -> Any:
    """A command-line string as the type of the value it replaces
    (config.py:93-109, with literal_eval in place of yaml)."""
    if isinstance(like, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(like, int):
        try:
            return int(val)
        except ValueError:
            return float(val)
    if isinstance(like, float):
        return float(val)
    try:
        return ast.literal_eval(val)
    except (ValueError, SyntaxError):
        return val


# ---------------------------------------------------------------------------
# Default tree: field for field with bem_tpu/classification/config.py:121-233
# ---------------------------------------------------------------------------

_C = CfgNode()
_C.BASE = [""]

_C.DATA = CfgNode()
_C.DATA.BATCH_SIZE = 128
_C.DATA.DATA_PATH = ""
_C.DATA.DATASET = "imagenet"
_C.DATA.IMG_SIZE = 224
_C.DATA.INTERPOLATION = "bicubic"
_C.DATA.ZIP_MODE = False
_C.DATA.CACHE_MODE = "part"
_C.DATA.PIN_MEMORY = True
_C.DATA.NUM_WORKERS = 8
_C.DATA.MASK_PATCH_SIZE = 32
_C.DATA.MASK_RATIO = 0.6

_C.MODEL = CfgNode()
_C.MODEL.TYPE = "vssm"
_C.MODEL.NAME = "vssm_tiny_224"
_C.MODEL.PRETRAINED = ""
_C.MODEL.RESUME = ""
_C.MODEL.NUM_CLASSES = 1000
_C.MODEL.DROP_RATE = 0.0
_C.MODEL.DROP_PATH_RATE = 0.1
_C.MODEL.LABEL_SMOOTHING = 0.1
_C.MODEL.MMCKPT = False

_C.MODEL.VSSM = CfgNode()
_C.MODEL.VSSM.PATCH_SIZE = 4
_C.MODEL.VSSM.IN_CHANS = 3
_C.MODEL.VSSM.DEPTHS = [2, 2, 9, 2]
_C.MODEL.VSSM.EMBED_DIM = 96
_C.MODEL.VSSM.SSM_D_STATE = 16
_C.MODEL.VSSM.SSM_RATIO = 2.0
_C.MODEL.VSSM.SSM_RANK_RATIO = 2.0
_C.MODEL.VSSM.SSM_DT_RANK = "auto"
_C.MODEL.VSSM.SSM_ACT_LAYER = "silu"
_C.MODEL.VSSM.SSM_CONV = 3
_C.MODEL.VSSM.SSM_CONV_BIAS = True
_C.MODEL.VSSM.SSM_DROP_RATE = 0.0
_C.MODEL.VSSM.SSM_INIT = "v0"
_C.MODEL.VSSM.SSM_FORWARDTYPE = "v2"
_C.MODEL.VSSM.MLP_RATIO = 4.0
_C.MODEL.VSSM.MLP_ACT_LAYER = "gelu"
_C.MODEL.VSSM.MLP_DROP_RATE = 0.0
_C.MODEL.VSSM.PATCH_NORM = True
_C.MODEL.VSSM.NORM_LAYER = "ln"
_C.MODEL.VSSM.DOWNSAMPLE = "v2"
_C.MODEL.VSSM.PATCHEMBED = "v2"
_C.MODEL.VSSM.POSEMBED = False
_C.MODEL.VSSM.GMLP = False

_C.TRAIN = CfgNode()
_C.TRAIN.START_EPOCH = 0
_C.TRAIN.EPOCHS = 300
_C.TRAIN.WARMUP_EPOCHS = 20
_C.TRAIN.WEIGHT_DECAY = 0.05
_C.TRAIN.BASE_LR = 5e-4
_C.TRAIN.WARMUP_LR = 5e-7
_C.TRAIN.MIN_LR = 5e-6
_C.TRAIN.CLIP_GRAD = 5.0
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.ACCUMULATION_STEPS = 1
_C.TRAIN.USE_CHECKPOINT = False

_C.TRAIN.LR_SCHEDULER = CfgNode()
_C.TRAIN.LR_SCHEDULER.NAME = "cosine"
_C.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
_C.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1
_C.TRAIN.LR_SCHEDULER.WARMUP_PREFIX = True
_C.TRAIN.LR_SCHEDULER.GAMMA = 0.1
_C.TRAIN.LR_SCHEDULER.MULTISTEPS = []

_C.TRAIN.OPTIMIZER = CfgNode()
_C.TRAIN.OPTIMIZER.NAME = "adamw"
_C.TRAIN.OPTIMIZER.EPS = 1e-8
_C.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)
_C.TRAIN.OPTIMIZER.MOMENTUM = 0.9
_C.TRAIN.LAYER_DECAY = 1.0

_C.TRAIN.MOE = CfgNode()
_C.TRAIN.MOE.SAVE_MASTER = False

_C.AUG = CfgNode()
_C.AUG.COLOR_JITTER = 0.4
_C.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
_C.AUG.REPROB = 0.25
_C.AUG.REMODE = "pixel"
_C.AUG.RECOUNT = 1
_C.AUG.MIXUP = 0.8
_C.AUG.CUTMIX = 1.0
_C.AUG.CUTMIX_MINMAX = None
_C.AUG.MIXUP_PROB = 1.0
_C.AUG.MIXUP_SWITCH_PROB = 0.5
_C.AUG.MIXUP_MODE = "batch"

_C.TEST = CfgNode()
_C.TEST.CROP = True
_C.TEST.SEQUENTIAL = False
_C.TEST.SHUFFLE = False

_C.ENABLE_AMP = False
_C.AMP_ENABLE = True
_C.AMP_OPT_LEVEL = ""
_C.OUTPUT = ""
_C.TAG = "default"
_C.SAVE_FREQ = 1
_C.PRINT_FREQ = 10
_C.SEED = 0
_C.EVAL_MODE = False
_C.THROUGHPUT_MODE = False
_C.TRAINCOST_MODE = False
_C.FUSED_LAYERNORM = False


def get_config() -> CfgNode:
    """A fresh copy of the default tree."""
    return _C.clone()
