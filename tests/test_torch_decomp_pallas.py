"""The flagship, DecompDualBranchDDWavelet, against bem_tpu on its Pallas
kernels (interpret mode): n_feat 8, blocks (1,1,1), model4, 16x24 inputs
of 6 channels, fp32; bem_tpu's VSSLevels run their scan pairs and tail
as kernels through the channel-first core (bem_tpu/nn/ss2d.py). The
port's seeded init with ``load_frozen``, carried by
``convert.state_dict_to_flax``; 1e-3, as test_torch_decomp_archs.py
holds the XLA backend. XLA's optimizations are off for the compile
(test_torch_cpu_setup.py), and the jitted interpret-mode traces are
dropped when the module ends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax

from test_torch_decomp_archs import B, H, W, cfg
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)

ARCH = "DecompDualBranchDDWavelet"


@pytest.fixture(scope="module", autouse=True)
def _clear_caches():
    """Drop the jitted interpret-mode traces when the module ends."""
    yield
    jax.clear_caches()


def test_flagship_matches_pallas():
    x = np.random.default_rng(0).random((B, H, W, 6)).astype(np.float32)
    m = build_network(cfg(ARCH), torch.Generator().manual_seed(1)).load_frozen()
    with torch.no_grad():
        got = m(torch.from_numpy(x))[-1].numpy()
    net = jax_build(dict(cfg(ARCH), scan_backend="pallas"))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(m))
    want = np.asarray(jax.jit(lambda p, v: net.apply({"params": p}, v)[-1])(params,
                                                                            jnp.asarray(x)))
    assert got.shape == want.shape == (B, H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
