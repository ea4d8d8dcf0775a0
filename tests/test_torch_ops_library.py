"""The kernel rows as ``torch.library`` operators (``bem::``).

Every operator passes ``torch.library.opcheck`` (its schema, its autograd
registration, its fake implementation against the CPU one, and a dynamic-
shape AOT trace) at small shapes on the fp32 and bf16 streams, and its
fake implementation gives exactly the CPU implementation's shapes, dtypes
and strides. Then the routing: a public wrapper calls its operator (an
export of it holds the bem:: node), a CUDA implementation refuses a CPU
stream, and ``FlopCounterMode`` counts the work inside an operator as it
counts the plain version's outside one.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from bem_tpu_torch.ops import gdmlp_fused, scan, scan_fused, ss2d_fused, ss2d_seq, ss2d_tail

from test_torch_cpu_setup import one_torch_thread  # noqa: F401  (module fixture)

DTYPES = (torch.float32, torch.bfloat16)


def _t(rng, shape, scale=1.0, dtype=torch.float32):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(dtype)


def _dir_weights(rng, C, N, R=2, K=4):
    P = R + 2 * N
    return (_t(rng, (K, P, C), C ** -0.5), _t(rng, (K, C, R), 0.5), _t(rng, (K, C), 0.1),
            -torch.exp(_t(rng, (K, C, N), 0.3)), _t(rng, (K, C), 0.5))


def _cases(dtype):
    """(operator, args) at small shapes."""
    rng = np.random.default_rng(0)
    B, C, H, W, Dh, N = 2, 8, 6, 10, 16, 2
    L = H * W
    x = _t(rng, (B, C, L), 1.0, dtype)
    stem = (x, _t(rng, (Dh, C), C ** -0.5), _t(rng, (Dh,), 0.1), _t(rng, (Dh, 9), 0.3),
            _t(rng, (Dh,), 0.1), H, W, _t(rng, (C,), 0.2) + 1, _t(rng, (C,), 0.1))
    gd = (x, _t(rng, (2 * Dh, C), C ** -0.5), None, _t(rng, (2 * Dh, 9), 0.3), None,
          _t(rng, (C, Dh), Dh ** -0.5), _t(rng, (C,), 0.1), H, W, None, None, True)
    Wx, Wdt, bias, A, D = _dir_weights(rng, C, N)
    seq = (x, Wx, Wdt, bias, A, D, "row")
    tail = (x, _t(rng, (B, C, L), 1.0, dtype), _t(rng, (C,), 0.2) + 1, _t(rng, (C,), 0.1),
            _t(rng, (C, 12), 0.3), None, _t(rng, (B, 12, L), 1.0, dtype))
    fwd, rev = [Wx[1], Wdt[1], bias[1], A[1]], [Wx[3], Wdt[3], bias[3], A[3]]
    T = 4
    col_sum = (x, fwd, rev, H, W, T)
    a_f, b_f, a_r, b_r = ss2d_seq.ss2d_col_sum(x, fwd, rev, H, W, T)
    h_f, h_r = scan.linear_scan(a_f, b_f), scan.linear_scan(a_r, b_r, True)
    col_dir = (x, fwd, rev, D[1] + D[3], h_f, h_r, _t(rng, (B, C, L), 1.0, dtype), H, W, T)
    lin = (torch.rand(3, 40, 5), _t(rng, (3, 40, 5)), True)
    Bt, K, Cd, Ls, Ns = 2, 2, 4, 40, 4
    sel = (_t(rng, (Bt, K, Cd, Ls), 1.0, dtype), _t(rng, (Bt, K, Cd, Ls), 0.5, dtype),
           -torch.exp(_t(rng, (K * Cd, Ns), 0.3)), _t(rng, (Bt, K, Ns, Ls), 1.0, dtype),
           _t(rng, (Bt, K, Ns, Ls), 1.0, dtype), _t(rng, (K * Cd,), 0.5), None, True)
    xs2 = _t(rng, (B, 2, C, L), 1.0, dtype)
    fused = [(xs2, *_dir_weights(rng, C, 4), clamp, ckpt)
             for clamp, ckpt in ((False, False), (True, False), (False, True))]
    cases = [("stem_fused", stem), ("gdmlp_fused", gd), ("ss2d_seq_pair", seq),
             ("ss2d_tail", tail), ("ss2d_col_sum", col_sum), ("ss2d_col_dir", col_dir),
             ("selective_scan_fused", sel)]
    cases += [("ss2d_dir_fused", a) for a in fused]
    if dtype == torch.float32:
        cases.append(("linear_scan", lin))
    return [(getattr(torch.ops.bem, name).default, args) for name, args in cases]


CASES = [(op, args, dtype) for dtype in DTYPES for op, args in _cases(dtype)]
IDS = [f"{op._name}-{str(dtype)[6:]}-{i}" for i, (op, _, dtype) in enumerate(CASES)]


@pytest.mark.parametrize("op, args, dtype", CASES, ids=IDS)
def test_opcheck(op, args, dtype):
    torch.library.opcheck(op, args)


def _meta(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in outs]


@pytest.mark.parametrize("op, args, dtype", CASES, ids=IDS)
def test_fake_gives_the_cpu_shapes(op, args, dtype):
    want = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args))
    assert _meta(fake) == _meta(want)


def test_wrappers_call_their_operators():
    """An export of each public wrapper holds its operator's node."""
    rng = np.random.default_rng(1)
    x = _t(rng, (1, 4, 12))
    Wx, Wdt, bias, A, D = _dir_weights(rng, 4, 1)
    calls = {
        "stem_fused": lambda x: gdmlp_fused.stem_fused_cf(
            x, torch.ones(6, 4), None, torch.ones(6, 9), None, 3, 4),
        "gdmlp_fused": lambda x: gdmlp_fused.gdmlp_fused_cf(
            x, torch.ones(6, 4), None, torch.ones(6, 9), None, torch.ones(4, 3), None, 3, 4),
        "ss2d_seq_pair": lambda x: ss2d_seq.ss2d_seq_pair(x, Wx, Wdt, bias, A, D, "row"),
        "ss2d_tail": lambda x: ss2d_tail.ss2d_tail_cf(x, None, torch.ones(4), torch.zeros(4),
                                                      torch.eye(4), None),
        "linear_scan": lambda x: scan.linear_scan(x.abs(), x),
        "ss2d_dir_fused": lambda x: ss2d_fused.ss2d_dir_fused(
            torch.stack([x, x], 1), Wx, Wdt, bias, A, D),
        "selective_scan_fused": lambda x: scan_fused.selective_scan_fused(
            x[:, None], x[:, None], -torch.ones(4, 1), x[:, None, :1], x[:, None, :1]),
    }
    for name, fn in calls.items():
        class M(torch.nn.Module):
            def forward(self, x):
                return fn(x)
        with torch.no_grad():
            program = torch.export.export(M(), (x,), strict=False)
        assert f"bem.{name}.default" in {str(n.target) for n in program.graph.nodes}, name


def test_cuda_implementations_refuse_cpu_streams():
    x = torch.zeros(1, 4, 12)
    with pytest.raises(ValueError, match="CUDA stream"):
        gdmlp_fused._stem_cuda(x, torch.ones(6, 4), None, torch.ones(6, 9), None, 3, 4, None,
                               None)
    with pytest.raises(ValueError, match="CUDA stream"):
        scan.scan_cuda(x, x, False)


def test_flop_counter_sees_inside_the_operators():
    """FlopCounterMode counts an operator's plain version as it counts the
    same function called outside the operator."""
    rng = np.random.default_rng(2)
    x = _t(rng, (2, 8, 60))
    args = (x, _t(rng, (16, 8)), None, _t(rng, (16, 9)), None, 6, 10, None, None)
    with FlopCounterMode(display=False) as inside:
        torch.ops.bem.stem_fused(*args)
    with FlopCounterMode(display=False) as outside:
        gdmlp_fused.stem_fused_cf_plain(*args)
    assert inside.get_total_flops() == outside.get_total_flops() == 2 * 2 * 60 * 16 * 8


def test_dispatch_ab_routes_every_operator_and_puts_it_back():
    """tools/op_dispatch_ab's direct route: inside ``direct()`` every
    wrapper global names its operator's CUDA implementation, with ``count``
    a counting call of it; outside, the operator again."""
    from bem_tpu_torch.tools import op_dispatch_ab

    ops = [getattr(m, g) for m, g, _ in op_dispatch_ab.ROUTES]
    assert all(isinstance(op, torch._ops.OpOverload) for op in ops)
    assert {op.name() for op in ops} == {
        "bem::stem_fused", "bem::gdmlp_fused", "bem::ss2d_seq_pair", "bem::ss2d_col_sum",
        "bem::ss2d_col_dir", "bem::ss2d_tail", "bem::linear_scan", "bem::ss2d_dir_fused",
        "bem::selective_scan_fused"}
    with op_dispatch_ab.direct():
        assert [getattr(m, g) for m, g, _ in op_dispatch_ab.ROUTES] == \
            [impl for _, _, impl in op_dispatch_ab.ROUTES]
    count = {"calls": 0}
    x = torch.zeros(1, 4, 12)
    with op_dispatch_ab.direct(count), pytest.raises(ValueError, match="CUDA stream"):
        scan._run(x, x, False)
    assert count["calls"] == 1
    assert [getattr(m, g) for m, g, _ in op_dispatch_ab.ROUTES] == ops
