"""The ConditionGenerator train step vs bem_tpu's on the Pallas kernels
(interpret mode), with XLA's optimizations off for the compile; the cases
and tolerances are test_torch_train.py's."""

from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_train import test_condition_generator_step_matches_jax as _step


def test_condition_generator_step_matches_pallas(monkeypatch):
    _step(monkeypatch, backend="pallas")
