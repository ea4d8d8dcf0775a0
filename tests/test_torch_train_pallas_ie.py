"""The ImageEnhancer train step vs bem_tpu's on the Pallas kernels (interpret
mode), at 16x16 (condition 4x4), with XLA's optimizations off for the
compile; the cases and tolerances are test_torch_train.py's."""

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_train import test_image_enhancer_step_matches_jax as _step


def test_image_enhancer_step_matches_pallas():
    _step(backend="pallas", hw=16)
