"""The port's utils/profiler.py, utils/plot_util.py and analysis/plot.py
against bem_tpu's.

- plot_util: the regex readers on a seeded log file (a thousands-comma
  step, non-matching lines), ``step_one``, ``smooth_data`` (equal to
  bem_tpu's), and the tensorboard reader on an event file written by
  tensorboardX: the steps and values written. (bem_tpu's reader first
  imports ``tensorboardX.event_file_loader``, which the installed
  tensorboardX lacks; past that import both read with tensorboard's
  EventAccumulator.)
- profiler: ``device_time`` calls the function warmup + iters times and
  returns the median, as bem_tpu's; ``trace`` writes a Chrome trace
  holding the ``annotate`` span.
- plot: both write the scatter PNG of the same size here (matplotlib,
  imported at the call in both).
"""

import json

import numpy as np
import pytest

from bem_tpu.analysis import plot as jax_plot
from bem_tpu.utils import plot_util as jax_plot_util
from bem_tpu.utils import profiler as jax_profiler
from bem_tpu_torch.analysis import plot
from bem_tpu_torch.utils import plot_util, profiler


@pytest.fixture
def log_file(tmp_path):
    rng = np.random.default_rng(4)
    lines = []
    for i, v in enumerate(rng.random(40)):
        step = (i + 1) * 250
        lines.append(f"2026-01-01 INFO: [epoch:  1, iter:{step:,}, lr:(2.0e-04,)] l_pix: {v:.4e}")
        if i % 7 == 0:
            lines.append(f"Validation LOL, # psnr: {20 + v:.4f}")
    path = tmp_path / "train.log"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("step_one", [False, True])
def test_text_readers_match_bem_tpu(log_file, step_one):
    pat2 = r"iter:\s*([\d,]+).*l_pix: ([-\d.e+]+)"
    got = plot_util.read_data_from_txt_2v(log_file, pat2, step_one)
    assert got == jax_plot_util.read_data_from_txt_2v(log_file, pat2, step_one)
    assert len(got[0]) == 40 and (got[0][-1] == (40 if step_one else 10000))
    pat1 = r"psnr: ([\d.]+)"
    assert (plot_util.read_data_from_txt_1v(log_file, pat1)
            == jax_plot_util.read_data_from_txt_1v(log_file, pat1))
    assert len(plot_util.read_data_from_txt_1v(log_file, pat1)) == 6
    for w in (0.0, 0.6, 0.99):
        assert plot_util.smooth_data(got[1], w) == jax_plot_util.smooth_data(got[1], w)


def test_tensorboard_reader_matches_bem_tpu(tmp_path):
    from tensorboardX import SummaryWriter

    rng = np.random.default_rng(5)
    values = rng.random(12).astype(np.float32)
    with SummaryWriter(str(tmp_path)) as w:
        for i, v in enumerate(values):
            w.add_scalar("losses/l_pix", float(v), 10 * i)
    steps, got = plot_util.read_data_from_tensorboard(str(tmp_path), "losses/l_pix")
    assert steps == [10 * i for i in range(12)]
    np.testing.assert_allclose(got, values, rtol=1e-7)


def test_device_time_and_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    import jax.numpy as jnp
    import torch

    t = profiler.device_time(fn, torch.ones(4), iters=5, warmup=2)
    assert len(calls) == 7 and t >= 0
    calls.clear()
    assert jax_profiler.device_time(lambda x: fn(x), jnp.ones(4), iters=5, warmup=2) >= 0
    assert len(calls) == 1  # bem_tpu jits: fn runs once, while tracing
    with profiler.trace(str(tmp_path / "tr")) as d:
        with profiler.annotate("bem.span"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "tr") and any(e.get("name") == "bem.span" for e in events)


def test_scatter_matches_bem_tpu(tmp_path):
    import matplotlib.image as mpimg

    models = [{"name": "BEM", "flops": 3.2, "psnr": 24.1, "params": 1.1},
              {"name": "EDSR", "flops": 90.0, "psnr": 21.0}]
    a = plot.psnr_vs_flops_scatter(models, str(tmp_path / "port.png"))
    b = jax_plot.psnr_vs_flops_scatter(models, str(tmp_path / "jax.png"))
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape == (750, 1050, 4)
    np.testing.assert_array_equal(pa, pb)
