"""The VSSM classifier's bf16 stream (bf16 images, fp32 params: the
throughput probe's, train.py:104-114) at narrow width, d_state 16, B=2
(the clamped core): the port's logits vs bem_tpu's within 2 bf16 ulps of
their largest entry. Set-up as test_torch_vssm.py. Also the block's Mlp
and gMlp on their own.
"""

import jax.numpy as jnp
import torch

from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_vssm import _close, images, jax_logits, narrow, port_model
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)


def test_logits_bf16_stream():
    kw = narrow(ssm_d_state=16, ssm_ratio=2.0)
    model = port_model(kw, seed=1)
    x = images(2, seed=2)
    want = jax_logits(kw, state_dict_to_flax(model), x, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = model(xb)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 2 ** -7)


def test_mlp_and_gmlp_match():
    """The classifier block's Mlp and gMlp (vss.py:105-130) on the same
    weights, channels-last there and channel-first here (fp32, 1e-6)."""
    import jax
    import numpy as np

    from bem_tpu.nn.vss import GMlp as JaxGMlp
    from bem_tpu.nn.vss import Mlp as JaxMlp
    from bem_tpu_torch.nn import GMlp, Mlp, init

    x = np.random.default_rng(4).standard_normal((2, 5, 6, 8)).astype(np.float32)
    for port, ref in ((Mlp(8, 32, 8), JaxMlp(32, 8)), (GMlp(8, 32, 8), JaxGMlp(32, 8))):
        init.initialize(port, torch.Generator().manual_seed(0))
        params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(port))
        want = np.asarray(ref.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
