"""The classification harness's config tree, without PyYAML.

Counterpart of bem_tpu/classification/config.py (reference
basicsr/vmamba/config.py): a dict subclass with attribute access,
freeze / defrost, clone, ``merge_from_list``, ``merge_from_file`` with
recursive ``BASE`` files, ``dump``, the default tree field for field
(bem_tpu/classification/config.py:121-233) and ``update_config`` /
``get_config(args)``, the command line's table from argument to field.
YAML is read by :mod:`..utils.yaml_lite` (the card's machine has no
PyYAML), which resolves scalars as ``yaml.safe_load`` does.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Any, List

from ..utils.yaml_lite import load as yaml_load


class CfgNode(dict):
    """yacs.config.CfgNode lookalike: a nested dict with attribute access;
    a frozen node refuses attribute assignment."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        for k, v in (init_dict or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set {name} on an immutable CfgNode (call "
                                 "defrost() first)")
        self[name] = value

    def freeze(self):
        self._set_frozen(True)

    def defrost(self):
        self._set_frozen(False)

    def _set_frozen(self, frozen: bool):
        self.__dict__[CfgNode.IMMUTABLE] = frozen
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def clone(self) -> "CfgNode":
        c = CfgNode()
        for k, v in self.items():
            c[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return c

    def _merge_dict(self, other: dict):
        """Nested dicts merge into existing nodes; other values replace."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k]._merge_dict(v)
            elif isinstance(v, dict):
                self[k] = CfgNode(v)
            else:
                self[k] = v

    def merge_from_file(self, cfg_file: str):
        with open(cfg_file) as f:
            self._merge_dict(yaml_load(f.read(), cfg_file) or {})

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

    def dump(self) -> str:
        """The tree as YAML (block mappings, flow lists, single-quoted
        strings) that yaml_lite and PyYAML read back to the same values,
        tuples as lists (as ``yaml.safe_dump`` writes them)."""
        lines = []

        def walk(node, indent):
            for k, v in node.items():
                if isinstance(v, dict):
                    lines.append(f"{' ' * indent}{k}:" + ("" if v else " {}"))
                    walk(v, indent + 2)
                else:
                    lines.append(f"{' ' * indent}{k}: {_yaml_scalar(v)}")

        walk(self, 0)
        return "\n".join(lines) + "\n"


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        return r.replace("e", ".0e") if "e" in r and "." not in r else r
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    raise TypeError(f"dump: cannot write {type(v).__name__} {v!r}")


def _coerce(val: str, like: Any) -> Any:
    """A command-line string as the type of the value it replaces
    (config.py:99-117): bool, int (float if it does not parse), float;
    otherwise as YAML reads it, the string itself where YAML refuses it."""
    if isinstance(like, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(like, int):
        try:
            return int(val)
        except ValueError:
            return float(val)
    if isinstance(like, float):
        return float(val)
    if isinstance(like, (list, tuple)):
        return yaml_load(val)
    try:
        return yaml_load(val)
    except ValueError:
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


def _update_config_from_file(config: CfgNode, cfg_file: str):
    """Merge ``cfg_file`` after its ``BASE`` files, each path relative to
    the file's directory, recursively (config.py:236-244)."""
    with open(cfg_file) as f:
        yaml_cfg = yaml_load(f.read(), cfg_file) or {}
    for base in yaml_cfg.get("BASE", [""]):
        if base:
            _update_config_from_file(config, os.path.join(os.path.dirname(cfg_file), base))
    config.merge_from_file(cfg_file)


# command-line argument -> config field, set where the argument is given
_SIMPLE = {"batch_size": ("DATA", "BATCH_SIZE"), "data_path": ("DATA", "DATA_PATH"),
           "cache_mode": ("DATA", "CACHE_MODE"), "pretrained": ("MODEL", "PRETRAINED"),
           "resume": ("MODEL", "RESUME"), "accumulation_steps": ("TRAIN", "ACCUMULATION_STEPS"),
           "output": ("OUTPUT",), "tag": ("TAG",)}
_FLAGS = {"zip": ("DATA", "ZIP_MODE", True), "use_checkpoint": ("TRAIN", "USE_CHECKPOINT", True),
          "disable_amp": ("AMP_ENABLE", False), "eval": ("EVAL_MODE", True),
          "throughput": ("THROUGHPUT_MODE", True)}


def _set(config, path, value):
    node = config
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def update_config(config: CfgNode, args) -> CfgNode:
    """The command line on the tree (config.py:247-282): ``--cfg`` with its
    BASE files, ``--opts``, each given simple argument (a falsy one is
    skipped, as in bem_tpu), the flags, then OUTPUT joined as
    <OUTPUT or 'output'>/<MODEL.NAME>/<TAG>."""
    if getattr(args, "cfg", None):
        _update_config_from_file(config, args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)
    for attr, path in _SIMPLE.items():
        val = getattr(args, attr, None)
        if val:
            _set(config, path, val)
    for attr, spec in _FLAGS.items():
        if getattr(args, attr, False):
            _set(config, spec[:-1], spec[-1])
    config.OUTPUT = os.path.join(config.OUTPUT or "output", config.MODEL.NAME, config.TAG)
    return config


def get_config(args=None) -> CfgNode:
    """A fresh copy of the default tree, with ``args`` applied when given."""
    config = _C.clone()
    if args is not None:
        update_config(config, args)
    return config


def vmamba_tiny(cfg: CfgNode, forward_type: str = "v05_noz") -> CfgNode:
    """``cfg`` with bem_tpu's ``vmamba_tiny`` fields (nn/vssm.py:180-183):
    depths (2, 2, 5, 2), embed 96, d_state 1, ssm_ratio 2, no conv bias,
    mlp_ratio 4, v3 downsampling, v2 patch embedding; ``forward_type``."""
    v = cfg.MODEL.VSSM
    v.DEPTHS, v.EMBED_DIM, v.SSM_D_STATE, v.SSM_RATIO = [2, 2, 5, 2], 96, 1, 2.0
    v.SSM_CONV_BIAS, v.MLP_RATIO, v.DOWNSAMPLE, v.PATCHEMBED = False, 4.0, "v3", "v2"
    v.SSM_FORWARDTYPE = forward_type
    return cfg
