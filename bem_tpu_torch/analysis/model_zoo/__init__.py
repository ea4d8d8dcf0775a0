"""The baseline model zoo of the PSNR-vs-FLOPs comparison (counterpart of
bem_tpu/analysis/model_zoo): HWMNet, LLFormer, RetinexFormer, UVMNet,
EDSR, HAT, MambaIR, RCAN and SwinIR, channel-first.

Each ``build*`` returns the module at the reference's comparison config
with seeded weights (``gen``, a CPU generator; seed 0 when omitted).
Module and parameter names are bem_tpu's: ``bem_tpu_torch.convert``
loads bem_tpu's ``init`` variables into them."""

from .edsr_rcan import EDSR, RCAN, buildEDSR, buildRCAN
from .hwmnet import HWMNet, buildHWMNet
from .llformer import LLFormer, buildLLFormer
from .mambair import MambaIR, buildMambaIR
from .retinexformer import RetinexFormer, buildRetinexFormer
from .swinir_hat import HAT, SwinIR, buildHAT, buildSwinIR
from .uvmnet import UVMNetUNet, buildUVMNet

BUILDERS = {
    "EDSR": buildEDSR,
    "RCAN": buildRCAN,
    "HWMNet": buildHWMNet,
    "LLFormer": buildLLFormer,
    "RetinexFormer": buildRetinexFormer,
    "UVMNet": buildUVMNet,
    "MambaIR": buildMambaIR,
    "SwinIR": buildSwinIR,
    "HAT": buildHAT,
}

__all__ = ["BUILDERS", "EDSR", "HAT", "HWMNet", "LLFormer", "MambaIR", "RCAN", "RetinexFormer",
           "SwinIR", "UVMNetUNet"]
