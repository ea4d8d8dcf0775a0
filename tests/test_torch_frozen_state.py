"""A Decomp net's ``.state`` in bem_tpu's ``multi_transform`` layout, both ways.

The flagship (DecompDualBranchDDWavelet, n_feat 8, QD model4 frozen) under
the ImageEnhancer trainer. bem_tpu partitions its optimizer into "train"
and "frozen" (``set_to_zero``); flax writes the state as ``inner_states /
{train, frozen} / inner_state``, the frozen leaves of Adam's moments as
empty dicts (``MaskedNode``).

- The port's state tree has exactly the structure of bem_tpu's own
  ``init_state`` (every key, the empty frozen leaves included).
- A ``.state`` the port writes after two steps resumes in bem_tpu (its
  ``load_state`` onto its TrainState) with the same params, step, count and
  moments.
- A ``.state`` bem_tpu writes (random params and moments, step 5) resumes
  in the port with the same params, step, count and moments; the frozen
  moments are 0.
- A net without frozen subtrees keeps the plain chain and refuses a
  partitioned state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from bem_tpu.models import build_model as jax_build_model
from bem_tpu.utils import checkpoint as jck
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import build_model

from test_trainers import make_batch, make_opt
from test_torch_checkpoint_write import _assert_trees_equal, _copy, _flat
from test_torch_cpu_setup import one_torch_thread, quick_compile  # noqa: F401  (module fixtures)
from test_torch_flagship_train import FLAGSHIP


def _opt(tmp_path):
    opt = make_opt("ImageEnhancer")
    opt["network_g"] = dict(FLAGSHIP)
    opt["path"] = {"experiments_root": str(tmp_path / "exp")}
    return opt


@pytest.fixture
def trainers(tmp_path):
    """The port's flagship trainer after two steps, and bem_tpu's started from
    the port's initial weights."""
    net = build_network(FLAGSHIP, torch.Generator().manual_seed(0)).load_frozen()
    params0 = _copy(state_dict_to_flax(net))
    pm = build_model(_opt(tmp_path), device="cpu", net=net)
    batch = make_batch(np.random.default_rng(0), H=16, W=16, down=4)
    for _ in range(2):
        pm.train_step(batch)
    jopt = _opt(tmp_path)
    jopt["network_g"]["scan_backend"] = "xla"
    jm = jax_build_model(jopt)
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    return pm, jm


def _pytree_leaves(tree):
    """{"a/b": array} of a pytree's array leaves (a MaskedNode has none)."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _train_adam(opt_state):
    return opt_state.inner_states["train"].inner_state[-1][0]


def _structure(tree, prefix=""):
    """Every path of a state dict, leaves and empty dicts alike."""
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out |= _structure(v, f"{prefix}{k}/")
        else:
            out.add(f"{prefix}{k}" + ("{}" if isinstance(v, dict) else ""))
    return out


def test_state_tree_is_bem_tpus(trainers):
    pm, jm = trainers
    want = serialization.to_state_dict(jm.state.opt_state)
    got = pm.train_state()["opt_state"]
    assert _structure(got) == _structure(want)
    assert got["inner_states"]["frozen"] == {"inner_state": {}}
    mu = got["inner_states"]["train"]["inner_state"]["1"]["0"]["mu"]
    assert mu["decomp"]["conv_in"] == {"kernel": {}, "bias": {}}


def test_port_state_resumes_in_bem_tpu(trainers, tmp_path):
    pm, jm = trainers
    pm.save(0, 2)
    st = jck.load_state(str(tmp_path / "exp" / "training_states" / "2.state"), jm.state)
    adam = _train_adam(st.opt_state)
    assert int(st.step) == 2 and int(adam.count) == 2
    assert isinstance(st.opt_state.inner_states["frozen"].inner_state, optax.EmptyState)
    _assert_trees_equal(jax.device_get(st.params), state_dict_to_flax(pm.net), "params")
    trained = {k: v for k, v in pm.optimizer.mu.items() if k not in pm.optimizer.frozen}
    for what, moments in (("mu", pm.optimizer.mu), ("nu", pm.optimizer.nu)):
        want = state_dict_to_flax(pm.net, {k: moments[k] for k in trained}, subset=True)
        got = _pytree_leaves(getattr(adam, what))
        assert not any(k.startswith("decomp/") for k in got)  # MaskedNode leaves hold nothing
        assert set(got) == set(_flat(want))
        for k, v in _flat(want).items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
    # bem_tpu takes the next step from it (on its own key: the port's rng is
    # its generator's state)
    jm.state = st.replace(rng=jm.state.rng)
    logs = jm.train_step(make_batch(np.random.default_rng(1), H=16, W=16, down=4))
    assert np.isfinite(float(logs["l_total"])) and int(jm.state.step) == 3


def test_bem_tpu_state_resumes_in_port(trainers, tmp_path):
    pm, jm = trainers
    rng = np.random.default_rng(1)

    def rand(tree):
        return jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), tree)

    inner = jm.state.opt_state.inner_states["train"]
    chain = inner.inner_state
    adam = chain[-1][0]
    # random moments on the trained leaves; MaskedNode leaves stay as they are
    adam = adam._replace(count=jnp.asarray(5, jnp.int32), mu=rand(adam.mu),
                         nu=jax.tree.map(jnp.abs, rand(adam.nu)))
    chain = chain[:-1] + ((adam,) + chain[-1][1:],)
    opt_state = jm.state.opt_state._replace(inner_states={
        **jm.state.opt_state.inner_states, "train": inner._replace(inner_state=chain)})
    params = rand(jm.state.params)
    state = jm.state.replace(step=jnp.asarray(5, jnp.int32), params=params, opt_state=opt_state)
    path = str(tmp_path / "5.state")
    jck.save_state(path, state)
    pm.resume_training(path)
    assert pm.step == 5 and pm.optimizer.count == 5
    state = jax.device_get(state)
    _assert_trees_equal(state_dict_to_flax(pm.net), state.params, "params")
    frozen = pm.optimizer.frozen
    for what in ("mu", "nu"):
        moments = getattr(pm.optimizer, what)
        want = _pytree_leaves(getattr(state.opt_state.inner_states["train"].inner_state[-1][0],
                                      what))
        got = _flat(state_dict_to_flax(pm.net, {k: moments[k] for k in moments
                                                if k not in frozen}, subset=True))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
        assert all(not moments[k].any() for k in frozen)
    logs = pm.train_step(make_batch(np.random.default_rng(1), H=16, W=16, down=4))
    assert np.isfinite(float(logs["l_total"])) and pm.step == 6


def test_plain_net_keeps_the_chain_and_refuses_a_partition(trainers, tmp_path):
    pm, _ = trainers
    plain = build_model(make_opt("ImageEnhancer"), device="cpu")
    tree = plain.train_state()
    assert "inner_states" not in tree["opt_state"] and set(tree["opt_state"]) == {"0", "1"}
    with pytest.raises(ValueError, match="partitioned"):
        plain.load_train_state(pm.train_state())
    with pytest.raises(ValueError, match="partitioned"):
        pm.load_train_state(tree)
