"""K3b's launch and arithmetic (``znicz_torch/ops/lrn.py``) on the CPU.

The kernel (``csrc/lrn_bwd.cu``) runs only on the card.  Its launch is
chosen in Python, so it is checked here: the plan's blocks, groups and
units own every row and channel once, its rows of squares and of t reach
the window, its shared memory fits one Hopper block and its grid is
resident at once; its ring shrinks, then it refuses, only when one group
does not fit.  A plain-PyTorch walk of the kernel's arithmetic — squares
and t in rows padded with +0 to the plan's width, taps from ``lo`` in
order, each window started from its first tap — gives exactly the bits
of ``lrn_bwd_plain``, signed zeros included, on mostly-zero x (ReLU
output) and dy holding +0s and -0s.

The bf16 K3b runs the same design on 8-channel (16-byte) units where
``ops/lrn._bf16_bwd_plan`` takes the shape, else the simple kernel: its
plan is checked as the bf16 K3's is (``test_torch_lrn_plan.py``), and a
walk of its three passes on bf16 tensors — squares and t in +0-padded
bf16 rows read as the kernel reads their words, each window from its
first tap, s^nb from the table of powers, every operation rounded to
bf16 — gives the bits of
``lrn_bwd_plain`` and of the reference's interpret-mode vjp."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_bf16 import LRN_BF16_CASES, _lrn_operands
from test_torch_lrn_plan import (BF16_MAIN, _check_bf16_cover, _padded,
                                 _pow_table, _read, _units, _window8, _words)

#: one Hopper block's opt-in shared memory (H100: 227 KB)
SMEM_LIMIT = 232448
ALEXNET = {"conv1": (128 * 55 * 55, 96), "conv2": (128 * 27 * 27, 256)}
ALPHA, K = 1e-4, 2.0


def _check_cover(rows, C, p, n_sms=132):
    """Blocks walk equal runs of groups that own every row once; threads
    of a row own every unit once; the padded rows reach the window; the
    layout is ``_bwd_smem``'s and fits; every block is resident at
    once."""
    from znicz_torch import _build
    from znicz_torch.ops.lrn import _bwd_smem

    units = C // 4 if p.vec else C
    assert p.threads_per_row * p.rows <= 256
    assert 1 <= p.threads_per_row <= units
    assert sorted(u for t in range(p.threads_per_row)
                  for u in range(t, units, p.threads_per_row)) \
        == list(range(units))
    groups = -(-rows // p.rows)
    owned = [g for b in range(p.blocks)
             for g in range(b * p.groups_per_block,
                            min((b + 1) * p.groups_per_block, groups))]
    assert owned == list(range(groups))
    assert (p.blocks - 1) * p.groups_per_block < groups
    assert 1 <= p.stages <= 2
    assert p.smem == _bwd_smem(p.rows, C, p.stride, p.stages) <= SMEM_LIMIT
    assert p.blocks_per_sm == _build.resident_blocks(
        p.threads_per_row * p.rows, p.smem, SMEM_LIMIT) >= 1
    assert p.blocks <= n_sms * p.blocks_per_sm
    right = p.stride - p.pad - C
    assert p.pad >= -p.lo and right >= p.lo + p.taps - 1
    if p.vec:
        assert p.pad % 4 == 0 and p.stride % 4 == 0 and C % 4 == 0


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_bwd_plan_at_alexnet_shapes(layer):
    from znicz_torch.ops.lrn import _bwd_plan

    rows, C = ALEXNET[layer]
    p = _bwd_plan(rows, C, 5, True, SMEM_LIMIT, 132)
    _check_cover(rows, C, p)
    # two float4s a thread, kept in registers; n = 5 unrolled from three
    # 16-byte reads: pads of 4; a ring of two; 4 blocks an SM, all resident
    assert p.vec and p.threads_per_row == C // 8
    assert (p.pad, p.stride - p.pad - C, p.lo, p.taps) == (4, 4, -2, 5)
    assert p.stages == 2 and p.blocks_per_sm == 4


@pytest.mark.parametrize("rows,C,n,aligned", [
    (97, 33, 5, True),        # scalar: C % 4 != 0; rows no multiple of 7
    (50, 64, 4, True),        # even window
    (40, 64, 5, False),       # an unaligned operand: scalar
    (9, 3, 5, True),          # C < n
    (21, 1024, 7, True),      # a row of 128 threads
    (5, 4000, 5, True),       # four units a thread, past 48 KB
    (3, 601, 1, False),       # three channels a thread, scalar
])
def test_bwd_plan_covers_ragged_shapes(rows, C, n, aligned):
    from znicz_torch.ops.lrn import _bwd_plan

    p = _bwd_plan(rows, C, n, aligned, SMEM_LIMIT)
    _check_cover(rows, C, p)
    assert p.vec == (aligned and C % 4 == 0)
    for n_sms in (1, 7, 1000):
        _check_cover(rows, C, _bwd_plan(rows, C, n, aligned, SMEM_LIMIT,
                                        n_sms), n_sms)


def test_bwd_plan_shrinks_the_ring_then_refuses():
    from znicz_torch.ops.lrn import _bwd_plan

    assert [_bwd_plan(4, C, 5, True, SMEM_LIMIT).stages
            for C in (9000, 12000)] == [2, 1]
    with pytest.raises(ValueError, match="lrn_bwd kernel.*shared memory"):
        _bwd_plan(4, 15000, 5, True, SMEM_LIMIT)


def _inputs(shape, seed):
    """Mostly-zero x (ReLU output) and dy with a quarter +0, a quarter
    -0, from numpy."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape) - 0.5, 0.0) * 3.0
    dy = rng.normal(size=shape)
    u = rng.random(size=shape)
    dy = np.where(u < 0.25, 0.0, np.where(u < 0.5, -0.0, dy))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(dy.astype(np.float32)))


def _walk(x, dy, p, alpha, beta, k, first_tap=True):
    """K3b's arithmetic as planned: each window over a row padded with +0
    to the plan's width, taps from ``lo`` in order, started from the first
    tap (from +0 when ``first_tap`` is false); every scalar a float32, as
    the kernel's operands are."""
    C = x.shape[-1]

    def window(v):
        row = F.pad(v, (p.pad, p.stride - p.pad - C))
        acc = None if first_tap else torch.zeros_like(v)
        for o in range(p.lo, p.lo + p.taps):
            tap = row[..., p.pad + o:p.pad + o + C]
            acc = tap if acc is None else acc + tap
        return acc

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    s = f32(k) + f32(alpha) * window(x * x)
    sb = torch.pow(s, -beta)
    t = dy * x * sb / s
    return dy * sb - (f32(2.0 * alpha * beta) * x) * window(t)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape,n,beta,aligned", [
    ((3, 5, 7, 96), 5, 0.75, True),     # float4, unrolled
    ((2, 3, 5, 64), 5, 0.6, True),      # powf at beta 0.6
    ((4, 2, 2, 3), 5, 0.75, False),     # C < n
] + [((2, 3, 4, 13), n, 0.75, False) for n in range(1, 8)])
def test_kernel_walk_matches_plain_bit_for_bit(shape, n, beta, aligned):
    """The walk gives ``lrn_bwd_plain``'s bits, -0s included."""
    from znicz_torch.ops.lrn import _bwd_plan, lrn_bwd_plain

    x, dy = _inputs(shape, 10 + n)
    C = shape[-1]
    p = _bwd_plan(x.numel() // C, C, n, aligned, SMEM_LIMIT)
    want = lrn_bwd_plain(x, dy, n, ALPHA, beta, K)
    got = _walk(x, dy, p, ALPHA, beta, K)
    assert torch.equal(_bits(got), _bits(want))


def test_window_started_from_zero_loses_signed_zeros():
    """A window started from +0, as K3's forward starts its sums of
    squares, would turn a window of -0s into +0 and change dx's bits; the
    walk, started from the first tap, keeps them."""
    from znicz_torch.ops.lrn import _bwd_plan, lrn_bwd_plain

    x, dy = _inputs((2, 3, 4, 32), 5)
    for n in (1, 5):
        p = _bwd_plan(x.numel() // 32, 32, n, True, SMEM_LIMIT)
        want = _bits(lrn_bwd_plain(x, dy, n, ALPHA, 0.75, K))
        assert torch.equal(_bits(_walk(x, dy, p, ALPHA, 0.75, K)), want)
        assert not torch.equal(
            _bits(_walk(x, dy, p, ALPHA, 0.75, K, first_tap=False)), want)


# -- the bf16 K3b's ring: the same design on 8-channel units ------------------


@pytest.mark.parametrize("layer", sorted(BF16_MAIN))
def test_bf16_plan_takes_the_ring_at_main_path_shapes(layer):
    """AlexNet's conv1 and conv2 and CIFAR10's C 16 take the ring, with
    K3's rows, groups and pads (K3b's slots hold x and dy)."""
    from znicz_torch.ops.lrn import _bf16_bwd_plan, _bwd_smem

    rows, C = BF16_MAIN[layer]
    p = _bf16_bwd_plan(rows, C, 5, True, SMEM_LIMIT, 132)
    assert p is not None
    _check_bf16_cover(rows, C, p, _bwd_smem)
    assert (p.threads_per_row, p.rows) == {96: (6, 42), 256: (16, 16),
                                           16: (1, 256)}[C]
    assert (p.pad, p.stride - p.pad - C, p.lo, p.taps) == (8, 8, -2, 5)
    assert p.stages == 2


@pytest.mark.parametrize("rows,C,n", [
    (43, 96, 5), (7, 8, 1), (97, 24, 4), (21, 1024, 7), (3, 4096, 5),
    (1, 256, 2), (50, 32, 3), (50, 32, 6),
])
def test_bf16_plan_covers_ragged_shapes(rows, C, n):
    from znicz_torch.ops.lrn import _bf16_bwd_plan, _bwd_smem

    for n_sms in (1, 7, 132, 1000):
        p = _bf16_bwd_plan(rows, C, n, True, SMEM_LIMIT, n_sms)
        assert p is not None
        _check_bf16_cover(rows, C, p, _bwd_smem, n_sms)


@pytest.mark.parametrize("why,C,aligned,limit", [
    ("C % 8 != 0", 20, True, SMEM_LIMIT),
    ("odd C", 601, True, SMEM_LIMIT),
    ("an operand 2 bytes past 16", 64, False, SMEM_LIMIT),
    ("a row past 4096 channels", 4104, True, SMEM_LIMIT),
    ("no group fits", 1024, True, 8192),
])
def test_bf16_plan_takes_the_simple_kernel(why, C, aligned, limit):
    from znicz_torch.ops.lrn import _bf16_bwd_plan

    assert _bf16_bwd_plan(40, C, 5, aligned, limit) is None, why


def _bf16_bwd_walk(x, dy, n, alpha, beta, k, p):
    """The bf16 K3b ring kernel's three passes as planned, on the CPU:
    squares into a +0-padded row; per unit its windows, s, sb (read from
    the table of powers), t (into a second padded row) and dy * sb; per
    unit the windows of t and dx.  Every operation is a bf16 one
    (rounded), in the kernel's order."""
    from znicz_torch.ops.lrn import operand_constants

    a, kk, nb, c2 = operand_constants(torch.bfloat16, alpha, k, -beta,
                                      2.0 * alpha * beta)
    table = _pow_table(nb)
    C = x.shape[-1]
    xs, ds = x.reshape(-1, C), dy.reshape(-1, C)
    w = _words(_padded(xs * xs, p))
    t = torch.full_like(xs, float("nan"))
    g = torch.full_like(xs, float("nan"))
    for c in _units(C, p):
        s = kk + a * _window8(w, p.pad + c, p.lo, p.taps)
        sb = _read(table, s)
        d, v = ds[:, c:c + 8], xs[:, c:c + 8]
        t[:, c:c + 8] = ((d * v) * sb) / s
        g[:, c:c + 8] = d * sb
    tw = _words(_padded(t, p))
    dx = torch.full_like(xs, float("nan"))
    for c in _units(C, p):
        wt = _window8(tw, p.pad + c, p.lo, p.taps)
        dx[:, c:c + 8] = g[:, c:c + 8] - (c2 * xs[:, c:c + 8]) * wt
    return dx.view(x.shape)


@pytest.mark.parametrize("shape,n,alpha,beta,k,scale", LRN_BF16_CASES)
def test_bf16_ring_walk_matches_plain_and_reference(shape, n, alpha, beta, k,
                                                    scale):
    """The walk of the bf16 K3b's ring gives the bits of ``lrn_bwd_plain``
    on bf16 tensors and of the reference's ``lrn_pallas.lrn`` vjp (its
    kernels in interpret mode) on the same inputs, signed zeros
    included."""
    import jax

    from znicz_torch.ops.lrn import _bf16_bwd_plan, lrn_bwd_plain
    from znicz_tpu.ops.lrn_pallas import lrn as jax_lrn

    x, dy, tx, tdy = _lrn_operands(shape, scale, sum(shape) + n)
    C = shape[-1]
    p = _bf16_bwd_plan(tx.numel() // C, C, n, True, SMEM_LIMIT)
    assert p is not None
    got = _bf16_bwd_walk(tx, tdy, n, alpha, beta, k, p)
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy()
    np.testing.assert_array_equal(bits, lrn_bwd_plain(
        tx, tdy, n, alpha, beta, k).view(torch.int16).numpy())
    _, vjp = jax.vjp(lambda v: jax_lrn(v, n, alpha, beta, k), x)
    np.testing.assert_array_equal(bits, np.asarray(vjp(dy)[0]).view(np.int16))
