"""Log readers for plots (counterpart of bem_tpu/utils/plot_util.py;
reference: basicsr/utils/plot_util.py): scalars from tensorboard event
files (tensorboard imported at the call, as in bem_tpu), (step, value)
pairs and values from a text log by regular expression, and tensorboard's
exponential smoothing."""

from __future__ import annotations

import re


def read_data_from_tensorboard(log_path, tag):
    """(steps, values) of ``tag`` in the event files under ``log_path``."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        raise ImportError("tensorboard needed to parse event files") from None
    ea = EventAccumulator(log_path)
    ea.Reload()
    events = ea.Scalars(tag)
    return [e.step for e in events], [e.value for e in events]


def read_data_from_txt_2v(path, pattern, step_one=False):
    """(steps, values) from the lines of ``path`` that ``pattern`` (two
    groups: the step, commas allowed, and the value) matches; ``step_one``
    numbers the values 1, 2, ... instead."""
    steps, values = [], []
    pat = re.compile(pattern)
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                steps.append(int(m.group(1).replace(",", "")))
                values.append(float(m.group(2)))
    if step_one:
        steps = list(range(1, len(values) + 1))
    return steps, values


def read_data_from_txt_1v(path, pattern):
    """The values of the lines of ``path`` that ``pattern`` (one group) matches."""
    pat = re.compile(pattern)
    with open(path) as f:
        return [float(m.group(1)) for m in map(pat.search, f) if m]


def smooth_data(values, smooth_weight):
    """Tensorboard's smoothing: an exponential moving average from values[0]."""
    out = []
    last = values[0]
    for v in values:
        last = last * smooth_weight + (1 - smooth_weight) * v
        out.append(last)
    return out
