"""Trainers of the port (counterpart of bem_tpu/models)."""

from typing import Any, Dict

from .base_model import AdamWChain, BaseModel
from .condition_generator_model import ConditionGenerator
from .image_enhancer_model import ImageEnhancer

_MODELS = {"ImageEnhancer": ImageEnhancer, "ConditionGenerator": ConditionGenerator}


def build_model(opt: Dict[str, Any], device="cuda", net=None):
    """The trainer ``opt['model_type']`` on ``device`` (CUDA unless the
    caller asks for the CPU); ``net`` optionally supplies the network."""
    return _MODELS[opt["model_type"]](opt, device=device, net=net)


__all__ = ["AdamWChain", "BaseModel", "ConditionGenerator", "ImageEnhancer", "build_model"]
