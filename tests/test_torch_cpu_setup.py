"""Set-up the port's CPU test modules share: two module-scoped autouse
fixtures, imported by name into each ``test_torch_*.py`` that uses them.

- ``quick_compile``: XLA's optimizations off (``jax_disable_most_optimizations``)
  while the module runs, the previous setting restored after. bem_tpu's
  references there are small programs compiled once each; at -O0 XLA
  compiles them in a fraction of the time, and the functions are the same
  (the tests' tolerances are unchanged).
- ``one_torch_thread``: torch pinned to one intra-op thread while the
  module runs. The port's CPU path at the tests' sizes is many small ops;
  under the tier-1 run's six workers on the sandbox's cores, intra-op
  threads spin against each other.
"""

import jax
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def quick_compile():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fixtures_hold_inside_the_module():
    assert jax.config.read("jax_disable_most_optimizations") is True
    assert torch.get_num_threads() == 1
