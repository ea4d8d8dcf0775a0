"""An IE-only serving artifact of each package (counterpart of
tests/test_export.py, with tests/test_torch_export.py): the port's
``export_pipeline`` of its IE at bem_tpu's weights converted, against
bem_tpu's own ``export_pipeline`` artifact of the same net: the same
output within 1e-5 (fp32, both on the "xla" route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bem_tpu.archs import build_network as jax_build
from bem_tpu.enhancement.export import export_pipeline as jax_export
from bem_tpu.enhancement.export import load_pipeline as jax_load
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import load_flax_params
from bem_tpu_torch.enhancement.export import export_pipeline, load_pipeline

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_export import CFG


def test_ie_artifact_matches_bem_tpu(tmp_path):
    """An IE-only artifact of each package, the port's at bem_tpu's
    weights converted: the same output within 1e-5 (fp32, "xla" routes)."""
    cfg = dict(CFG, in_channels=6, out_channels=3, scan_backend="xla")
    x = np.random.default_rng(2).random((2, 32, 32, 6)).astype(np.float32)
    jnet = jax_build(cfg)
    v = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    jpath = str(tmp_path / "ie.jaxexport")
    jax_export(lambda v, x: jnet.apply(v, x)[-1], (v, jnp.asarray(x)), jpath)
    want = np.asarray(jax_load(jpath)(v, jnp.asarray(x)))

    ie = load_flax_params(build_network(cfg), jax.tree_util.tree_map(np.asarray, v)).eval()
    path = str(tmp_path / "ie.pt2")
    export_pipeline(lambda x: ie(x)[-1], (torch.from_numpy(x),), path)
    got = load_pipeline(path)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
