"""A vmamba_tiny-style VSSM (forward_type v05_noz, d_state 1, gMlp-free Mlp,
downsample v3, patch-embed v2) at narrow width: the port's logits vs
bem_tpu's. Its SS2Ds take the serving path's fused core in the NHWC layout
with the unfused stem (ss2d.py:217-389): the row pair (kernel 2), the
transpose-free column pair (kernels 5, 6) and the tail (kernel 3), in
Pallas interpret mode on bem_tpu's side. Tolerances as test_torch_vssm.py.
"""

import jax.numpy as jnp
import pytest
import torch

from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_vssm import _close, images, jax_logits, narrow, port_model
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v05_noz_logits(dtype):
    kw = narrow(ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=False, forward_type="v05_noz",
                downsample_version="v3")
    model = port_model(kw, clamp=True)
    x = images(2, seed=3)
    want = jax_logits(kw, state_dict_to_flax(model), x,
                      jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(dtype)).float().numpy()
    _close(got, want, 1e-5 if dtype == torch.float32 else 2 ** -7)
