"""The microbenchmarks' functions (kernels 12, 13): the port's plain versions
vs tools/microbench_vpu.py's Pallas kernels in interpret mode.

tools/ is not a package, so the tool is loaded from its file. Loading it
sets JAX_COMPILATION_CACHE_DIR and jax_compilation_cache_dir; both are put
back afterwards, so later tests in the same process see the configuration
they had. Data as the tool draws it (default_rng(0).random, fp32) at a
small shape: 2 blocks of (40, 128). Tolerance 1e-5 of the output's largest
entry (the same fp32 operations; multiply-add may be fused on one side).
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bem_tpu_torch.tools import microbench_vpu as port

TOOL = Path(__file__).resolve().parents[1] / "tools" / "microbench_vpu.py"
SHAPE = (2, 40, 128)
# the configuration before the tool is loaded
BEFORE = (os.environ.get("JAX_COMPILATION_CACHE_DIR"), jax.config.jax_compilation_cache_dir)


@pytest.fixture(scope="module")
def tool():
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("microbench_vpu_tool", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mod


def _pallas(kernel, x):
    n, c, lanes = x.shape
    spec = pl.BlockSpec((1, c, lanes), lambda i: (i, 0, 0))
    f = pl.pallas_call(kernel, grid=(n,), in_specs=[spec], out_specs=spec,
                       out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)
    return np.asarray(f(jnp.asarray(x)))


def _data():
    return np.random.default_rng(0).random(SHAPE).astype(np.float32)


def _check(got, want):
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def test_tool_load_keeps_jax_config(tool):
    assert tool.TOTAL == port.TOTAL and tool.C == port.C and tool.NPASS == port.NPASS
    now = (os.environ.get("JAX_COMPILATION_CACHE_DIR"), jax.config.jax_compilation_cache_dir)
    assert now == BEFORE


@pytest.mark.parametrize("npass", [10, 40])
def test_scan_step_matches_pallas(tool, npass):
    x = _data()
    want = _pallas(tool.make_kernel(SHAPE[-1], npass), x)
    _check(port.vpu_scan_step(torch.from_numpy(x), npass), want)


@pytest.mark.parametrize("mode", ["arith", "roll", "exp", "softplus"])
def test_op_rounds_match_pallas(tool, mode):
    x = _data()
    want = _pallas(tool.make_kernel2(SHAPE[-1], mode), x)
    _check(port.vpu_op_rounds(torch.from_numpy(x), mode), want)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        port.vpu_op_rounds(torch.zeros(SHAPE), "dot")


def test_data_is_the_tools_draw():
    """The port draws the flat sequence once and views it per lanes: the
    same numbers as the tool's per-shape draw."""
    total = 2 * 40 * 128
    flat = np.random.default_rng(0).random(total).astype(np.float32)
    np.testing.assert_array_equal(flat.reshape(SHAPE), _data())
