"""Metrics of the port (counterpart of bem_tpu/metrics): ``calculate_metric``
dispatches a ``val.metrics`` entry by its ``type``."""

from copy import deepcopy

from .niqe import calculate_niqe
from .psnr_ssim import calculate_psnr, calculate_ssim
from .uciqe_uiqm import calculate_uciqe, calculate_uiqm, getUCIQE, getUIQM

METRICS = {"calculate_niqe": calculate_niqe,
           "calculate_psnr": calculate_psnr, "calculate_ssim": calculate_ssim,
           "calculate_uciqe": calculate_uciqe, "calculate_uiqm": calculate_uiqm}


def calculate_metric(data, opt):
    """``opt['type']`` on ``data`` ({img, img2}) with the rest of ``opt`` as
    keyword arguments (metrics/__init__.py:17)."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    if metric_type not in METRICS:
        raise NotImplementedError(f"metric {metric_type} is not ported "
                                  f"(ported: {sorted(METRICS)})")
    return METRICS[metric_type](**data, **opt)
