"""The classifier's command line and config tree against bem_tpu's:
``parse_option`` and ``get_config`` give equal trees over argv cases
(``--cfg`` with nested ``BASE`` files, ``--opts`` of every kind of value,
each simple argument, each flag, a falsy argument skipped); freeze /
defrost; ``dump`` read back by yaml_lite and PyYAML to the same tree.
"""

import pytest
import yaml

from bem_tpu.classification.config import get_config as bem_get_config
from bem_tpu.classification.train import parse_option as bem_parse_option
from bem_tpu_torch.classification.config import CfgNode, get_config
from bem_tpu_torch.classification.train import parse_option
from bem_tpu_torch.utils.yaml_lite import load

BASE = """# the harness defaults at IMG_SIZE 224
DATA:
  IMG_SIZE: 224
  INTERPOLATION: bicubic
TRAIN:
  BASE_LR: 1.0e-3
  OPTIMIZER:
    BETAS: [0.85, 0.99]
"""
MID = """BASE: ['base.yaml']
MODEL:
  VSSM:
    DEPTHS: [2, 2, 5, 2]
    SSM_D_STATE: 1
    SSM_CONV_BIAS: false
AUG:
  MIXUP: 0.0
"""
MODEL = """BASE: ['../mid.yaml']
MODEL:
  NAME: vssm_tiny_test
  VSSM:
    EMBED_DIM: 64
    SSM_FORWARDTYPE: v05_noz
TRAIN:
  EPOCHS: 30
  WARMUP_EPOCHS: 2
TAG: run1
"""


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("cfg")
    (root / "base.yaml").write_text(BASE)
    (root / "mid.yaml").write_text(MID)
    (root / "models").mkdir()
    (root / "models" / "tiny.yaml").write_text(MODEL)
    return str(root / "models" / "tiny.yaml")


CASES = [
    [],
    ["--cfg", "{cfg}"],
    ["--cfg", "{cfg}", "--opts", "TRAIN.EPOCHS", "3", "MODEL.VSSM.DEPTHS", "[1, 2]",
     "AUG.AUTO_AUGMENT", "none", "TRAIN.OPTIMIZER.BETAS", "[0.8, 0.9]", "AUG.CUTMIX_MINMAX",
     "[0.2, 0.8]", "DATA.INTERPOLATION", "bilinear", "TRAIN.BASE_LR", "2e-4",
     "MODEL.VSSM.GMLP", "yes", "AUG.REPROB", "0", "DATA.BATCH_SIZE", "7.5"],
    ["--batch-size", "16", "--data-path", "/data/imagenet", "--cache-mode", "full",
     "--pretrained", "p.pth", "--resume", "r.pth", "--accumulation-steps", "2",
     "--output", "out", "--tag", "t1"],
    ["--batch-size", "0", "--tag", ""],
    ["--zip"], ["--use-checkpoint"], ["--disable_amp"], ["--eval"], ["--throughput"],
    ["--cfg", "{cfg}", "--eval", "--throughput", "--zip", "--batch-size", "4", "--opts",
     "MODEL.NUM_CLASSES", "10"],
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_parse_option_same_tree(cfg_file, i):
    argv = [a.format(cfg=cfg_file) for a in CASES[i]]
    args, cfg = parse_option(argv + ["--device", "cpu"] if "--opts" not in argv else
                             ["--device", "cpu"] + argv)
    bem_args, bem_cfg = bem_parse_option(argv)
    assert cfg == bem_cfg
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(bem_args)
    assert args.device == "cpu"
    assert parse_option(argv)[0].device == "cuda"


def test_get_config_without_args():
    assert get_config() == bem_get_config() and get_config(None) is not get_config(None)


def test_freeze_defrost():
    for c in (get_config(), bem_get_config()):
        assert not c.is_frozen()
        c.freeze()
        assert c.is_frozen() and c.MODEL.VSSM.is_frozen()
        with pytest.raises(AttributeError, match="immutable"):
            c.DATA.BATCH_SIZE = 2
        with pytest.raises(AttributeError, match="immutable"):
            c.SEED = 1
        c.defrost()
        c.DATA.BATCH_SIZE = 2
        assert c.DATA.BATCH_SIZE == 2 and not c.MODEL.is_frozen()
        c2 = c.clone()
        c2.MODEL.VSSM.DEPTHS.append(9)
        assert c.MODEL.VSSM.DEPTHS == [2, 2, 9, 2]


def _plain(n):
    return {k: _plain(v) if isinstance(v, dict) else list(v) if isinstance(v, tuple) else v
            for k, v in n.items()}


def test_dump_round_trip(cfg_file, tmp_path):
    cfg = parse_option(["--cfg", cfg_file, "--opts", "AUG.CUTMIX_MINMAX", "[0.2, 0.8]",
                        "TRAIN.MIN_LR", "1e-08", "AMP_OPT_LEVEL", "O1", "TAG", "'quoted'"])[1]
    cfg.MODEL.NAME = "it's: [not] a list"
    text = cfg.dump()
    assert load(text) == yaml.safe_load(text) == _plain(cfg)
    # the port's dump merged by bem_tpu (PyYAML) and by the port (yaml_lite) alike
    path = tmp_path / "dumped.yaml"
    path.write_text(text)
    a, b = get_config(), bem_get_config()
    a.merge_from_file(str(path))
    b.merge_from_file(str(path))
    assert _plain(a) == _plain(b) == _plain(cfg)
    assert isinstance(CfgNode({"x": {"y": 1}}).x, CfgNode)
