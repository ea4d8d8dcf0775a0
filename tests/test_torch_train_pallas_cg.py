"""The ConditionGenerator train step vs bem_tpu's on the Pallas kernels
(interpret mode), with XLA's optimizations off for the compile; the cases
and tolerances are test_torch_train.py's."""

from test_torch_train import test_condition_generator_step_matches_jax as _step
from test_torch_train_pallas_ie import quick_compile  # noqa: F401


def test_condition_generator_step_matches_pallas(monkeypatch, quick_compile):  # noqa: F811
    _step(monkeypatch, backend="pallas")
