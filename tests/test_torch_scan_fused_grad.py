"""selective_scan_fused's gradients: the port's autograd wrapper (its
backward recomputes through the unfolded composition, as bem_tpu's custom
VJP does) vs jax.vjp of bem_tpu's function, all seven gradients (u,
delta, A, B, C, D, dt bias; those of A, D and the bias summed over the
batch), within 1e-4 of each gradient's largest entry (fp32 sums in
another order). Inputs as test_torch_scan_fused.py makes them, with the
+12-bias channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bem_tpu.ops.scan_fused import selective_scan_fused as jax_scan_fused
from bem_tpu_torch.ops.scan_fused import selective_scan_fused

from test_torch_scan_fused import _inputs


@pytest.mark.parametrize("shape", [(2, 4, 16, 64, 1), (1, 4, 8, 32, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_jax(shape):
    args, _ = _inputs(shape, seed=3)
    g = np.random.default_rng(4).standard_normal(shape[:4]).astype(np.float32)
    _, vjp = jax.vjp(jax_scan_fused, *map(jnp.asarray, args))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(selective_scan_fused(*ins), ins, torch.from_numpy(g))
    assert len(got) == len(want) == 7
    for name, a, b in zip("u delta A B C D bias".split(), got, want):
        assert a.shape == b.shape, name
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * np.abs(b).max(), (name, err, np.abs(b).max())
