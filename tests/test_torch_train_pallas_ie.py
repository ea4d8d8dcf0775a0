"""The ImageEnhancer train step vs bem_tpu's on the Pallas kernels (interpret
mode), at 16x16 (condition 4x4), with XLA's optimizations off for the
compile; the cases and tolerances are test_torch_train.py's."""

import jax
import pytest

from test_torch_train import test_image_enhancer_step_matches_jax as _step


@pytest.fixture
def quick_compile():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def test_image_enhancer_step_matches_pallas(quick_compile):
    _step(backend="pallas", hw=16)
