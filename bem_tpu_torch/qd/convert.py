"""The shipped QD decomposition checkpoints (counterpart of
bem_tpu/qd/convert.py::load_decomp_params).

``checkpoints/model{1,2,3,4}_999.msgpack`` are byte-for-byte copies of
bem_tpu's converted reference checkpoints (flax params, channels-last);
they are read without flax by ``utils.checkpoint.msgpack_restore``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from ..utils.checkpoint import msgpack_restore

CHECKPOINT_DIR = os.path.join(os.path.dirname(__file__), "checkpoints")


def load_decomp_params(model_type: str) -> Dict[str, Any]:
    """The flax params tree of the shipped checkpoint of ``model_type``."""
    path = os.path.join(CHECKPOINT_DIR, f"{model_type}_999.msgpack")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No QD checkpoint for {model_type!r} at {path}")
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
