"""The port's checkpoint files against bem_tpu's, in both directions.

- The msgpack writer: byte for byte what ``flax.serialization.msgpack_serialize``
  writes (dict keys, ints, floats, str, None, bools, arrays and scalars of
  several dtypes, bf16, arrays chunked over the size limit).
- ``net_g`` files: the port's ``save`` read by bem_tpu's ``load_params``,
  bem_tpu's ``save_params`` (with ``params_ema``) read by the port's
  ``load_network``: every leaf equal.
- ``.state`` files: the port's read by bem_tpu's ``load_state`` onto its
  TrainState, bem_tpu's TrainState read by the port's ``resume_training``:
  params, EMA, Adam count / mu / nu, step and the Bayesian prior equal;
  bem_tpu's rng key restarts the port's stream from manual_seed + step.
- ``find_latest_state``, and ``load_network``'s strict and non-strict key
  reports (missing, unexpected, size-mismatched) as bem_tpu logs them.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from bem_tpu.models import build_model as jax_build_model
from bem_tpu.utils import checkpoint as jck
from bem_tpu_torch.archs import build_network
from bem_tpu_torch.convert import state_dict_to_flax
from bem_tpu_torch.models import build_model
from bem_tpu_torch.utils import checkpoint as pck

from test_trainers import make_batch, make_opt
from test_torch_cpu_setup import quick_compile  # noqa: F401  (module fixtures)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want, what):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:4])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _copy(tree):
    """state_dict_to_flax's leaves are views of the live parameters."""
    return {k: _copy(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _opt(model_type, tmp_path, **train):
    opt = make_opt(model_type)
    opt["train"].update(train)
    opt["path"] = {"experiments_root": str(tmp_path / "exp")}
    return opt


def _trainers(model_type, tmp_path, **train):
    """The port's trainer (narrow net, seeded) after two steps, and bem_tpu's
    trainer started from the port's initial weights."""
    popt = _opt(model_type, tmp_path, **train)
    net_opt = dict(popt["network_g"])
    if model_type == "ConditionGenerator":
        net_opt.update(bayesian=True, sigma_init=0.05)
    net = build_network(net_opt, torch.Generator().manual_seed(0))
    params0 = _copy(state_dict_to_flax(net))
    pm = build_model(popt, device="cpu", net=net)
    batch = make_batch(np.random.default_rng(0), H=32, W=32, down=4)
    for _ in range(2):
        pm.train_step(batch)
    jopt = _opt(model_type, tmp_path, **train)
    jopt["network_g"]["scan_backend"] = "xla"
    jm = jax_build_model(jopt)
    jm._init_variables = lambda rng, batch: {"params": params0}
    jm.init_state(batch, seed=0)
    return pm, jm


def _adam(state):
    return state.opt_state[-1][0]


def test_msgpack_writer_matches_flax(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"params": {"k": rng.random((3, 3, 4, 5)).astype(np.float32),
                       "b": np.zeros((0,), np.int64), "u": np.arange(16, dtype=np.uint8)},
            "step": np.asarray(7, np.int32), "scalar": np.float32(1.5), "none": None,
            "flag": True, "ints": [1, -5, 300, -200, 70000, 2 ** 40, -2 ** 40, 3.25],
            "long": "x" * 40, "empty": {}, "many": {str(i): i for i in range(20)},
            "bf16": jnp.asarray(rng.random((2, 3)), jnp.bfloat16),
            "chunked": rng.random((1000,)).astype(np.float32)}
    mine = dict(tree, bf16=torch.from_numpy(np.asarray(tree["bf16"], np.float32)).bfloat16())
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(pck, "MAX_CHUNK_SIZE", 1024)
    want = serialization.msgpack_serialize(tree)
    assert pck.msgpack_serialize(mine) == want
    back = pck.msgpack_restore(want)
    np.testing.assert_array_equal(back["chunked"], tree["chunked"])


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_net_files_cross_both_ways(model_type, tmp_path):
    pm, jm = _trainers(model_type, tmp_path, ema_decay=0.5)
    pm.save(0, 2)
    path = tmp_path / "exp" / "models" / "net_g_2.msgpack"
    _assert_trees_equal(jck.load_params(str(path)), state_dict_to_flax(pm.net), "params")
    _assert_trees_equal(jck.load_params(str(path), "params_ema"),
                        state_dict_to_flax(pm.net, pm.ema_params), "params_ema")

    # bem_tpu's file (other weights: its initial ones) into the port
    jpath = str(tmp_path / "jax_net.msgpack")
    jck.save_params(jpath, jm.state.params, extra={"params_ema": jm.state.ema_params})
    pm.load_network(jpath)
    _assert_trees_equal(state_dict_to_flax(pm.net), jax.device_get(jm.state.params), "loaded")


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_train_state_port_to_bem_tpu(model_type, tmp_path):
    pm, jm = _trainers(model_type, tmp_path, ema_decay=0.5)
    pm.save(0, 2)
    st = jck.load_state(str(tmp_path / "exp" / "training_states" / "2.state"), jm.state)
    assert int(st.step) == 2 and int(_adam(st).count) == 2 and int(st.opt_state[-1][2].count) == 2
    _assert_trees_equal(jax.device_get(st.params), state_dict_to_flax(pm.net), "params")
    _assert_trees_equal(jax.device_get(st.ema_params), state_dict_to_flax(pm.net, pm.ema_params),
                        "ema")
    _assert_trees_equal(jax.device_get(_adam(st).mu), state_dict_to_flax(pm.net, pm.optimizer.mu),
                        "mu")
    _assert_trees_equal(jax.device_get(_adam(st).nu), state_dict_to_flax(pm.net, pm.optimizer.nu),
                        "nu")
    if model_type == "ConditionGenerator":
        _assert_trees_equal(jax.device_get(st.bayes_prior),
                            state_dict_to_flax(pm.net, pm.bayes_prior, subset=True), "prior")
    else:
        assert st.bayes_prior is None
    np.testing.assert_array_equal(np.asarray(st.rng), pm.gen.get_state().numpy())


@pytest.mark.parametrize("model_type", ["ImageEnhancer", "ConditionGenerator"])
def test_train_state_bem_tpu_to_port(model_type, tmp_path, caplog):
    pm, jm = _trainers(model_type, tmp_path, ema_decay=0.5)
    rng = np.random.default_rng(1)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), t)
    adam = _adam(jm.state)._replace(count=jnp.asarray(5, jnp.int32), mu=rand(jm.state.params),
                                    nu=jax.tree.map(jnp.abs, rand(jm.state.params)))
    chain = jm.state.opt_state[:-1] + ((adam,) + jm.state.opt_state[-1][1:],)
    state = jm.state.replace(step=jnp.asarray(5, jnp.int32), params=rand(jm.state.params),
                             opt_state=chain, ema_params=rand(jm.state.params),
                             bayes_prior=None if jm.state.bayes_prior is None
                             else rand(jm.state.bayes_prior))
    path = str(tmp_path / "5.state")
    jck.save_state(path, state)
    with caplog.at_level(logging.WARNING):
        logging.getLogger("bem_tpu_torch").addHandler(caplog.handler)
        pm.resume_training(path)
        logging.getLogger("bem_tpu_torch").removeHandler(caplog.handler)
    assert pm.step == 5 and pm.optimizer.count == 5
    state = jax.device_get(state)
    _assert_trees_equal(state_dict_to_flax(pm.net), state.params, "params")
    _assert_trees_equal(state_dict_to_flax(pm.net, pm.ema_params), state.ema_params, "ema")
    _assert_trees_equal(state_dict_to_flax(pm.net, pm.optimizer.mu), _adam(state).mu, "mu")
    _assert_trees_equal(state_dict_to_flax(pm.net, pm.optimizer.nu), _adam(state).nu, "nu")
    if model_type == "ConditionGenerator":
        _assert_trees_equal(state_dict_to_flax(pm.net, pm.bayes_prior, subset=True),
                            state.bayes_prior, "prior")
    assert "restarts from manual_seed + step = 105" in caplog.text  # make_opt's seed 100
    want = torch.Generator().manual_seed(105)
    assert torch.equal(torch.randn(4, generator=pm.gen), torch.randn(4, generator=want))


def test_find_latest_state(tmp_path):
    for name in ("2.state", "10.state", "9.state", "x.state", "11.state.tmp", "3.msgpack"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "12.state").mkdir()  # a directory matches bem_tpu's pattern too
    assert pck.find_latest_state(str(tmp_path)) == jck.find_latest_state(str(tmp_path))
    assert pck.find_latest_state(str(tmp_path / "none")) is None


def _reports(logger_name, fn):
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger(logger_name)
    logger.addHandler(handler)
    try:
        try:
            fn()
            err = None
        except ValueError as e:
            err = str(e)
    finally:
        logger.removeHandler(handler)
    return [m for m in records if m.startswith("load_network:")], err


@pytest.mark.parametrize("strict", [True, False])
def test_load_network_key_reports(strict, tmp_path):
    pm, jm = _trainers("ImageEnhancer", tmp_path)
    params = jax.tree.map(np.asarray, jax.device_get(jm.state.params))
    params = dict(params)
    del params["mask_token"]  # missing
    params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}  # unexpected
    params["proj"] = dict(params["proj"], bias=np.ones((5,), np.float32))  # size mismatch
    path = str(tmp_path / "odd.msgpack")
    jck.save_params(path, params)
    before = _copy(state_dict_to_flax(pm.net))
    want = _reports("bem_tpu", lambda: jm.load_network(path, strict=strict))
    got = _reports("bem_tpu_torch", lambda: pm.load_network(path, strict=strict))
    assert len(want[0]) == 3 and got[0] == want[0]
    if strict:
        assert want[1] is not None and got[1] == want[1]
        return
    assert got[1] is None and want[1] is None
    # each keeps its own value where the file has none of the right shape
    # (bem_tpu's trainer is at its initial weights, the port's two steps on)
    kept = {"mask_token", "proj/bias"}
    port, jax_ = _flat(state_dict_to_flax(pm.net)), _flat(jax.device_get(jm.state.params))
    assert any(not np.array_equal(port[k], jax_[k]) for k in kept)
    for k, v in _flat(before).items():
        np.testing.assert_array_equal(port[k], v if k in kept else _flat(params)[k], err_msg=k)
