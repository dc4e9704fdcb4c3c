"""K3's window and launch (``znicz_torch/ops/lrn.py``) on the CPU.

The kernels (``csrc/lrn.cu``, ``csrc/lrn_bwd.cu``) run only on the card.
The window they sum and K3's launch are chosen in Python, so they are
checked here: the offsets the wrapper passes are the reference's for odd
and even windows and for fewer channels than the window; a float32 sum
over a zero-padded row in those offsets' order is bit-equal to the
reference's ``windowed_channel_sum``; the plan's blocks, groups and
units own every row and channel once, its rows of squares reach the
window, and its shared memory fits one Hopper block; and a plain-PyTorch
walk of the kernel's arithmetic (squares in a padded row, taps in order)
gives exactly what ``lrn_plain`` gives."""

import numpy as np
import pytest
import torch

#: one Hopper block's opt-in shared memory (H100: 227 KB)
SMEM_LIMIT = 232448
ALEXNET = {"conv1": (128 * 55 * 55, 96), "conv2": (128 * 27 * 27, 256)}


def _padded_sum(t, lo, taps, pad, right):
    """The kernel's window: each row of ``t`` between ``pad`` and
    ``right`` zeros, taps ``lo .. lo + taps - 1`` added in order to 0."""
    C = t.shape[-1]
    row = np.concatenate([np.zeros(t.shape[:-1] + (pad,), t.dtype), t,
                          np.zeros(t.shape[:-1] + (right,), t.dtype)], -1)
    acc = np.zeros_like(t)
    for o in range(lo, lo + taps):
        acc = acc + row[..., pad + o:pad + o + C]
    return acc


@pytest.mark.parametrize("n,C", [(n, 13) for n in range(1, 8)]
                         + [(5, 3), (4, 2), (7, 4)])
def test_window_offsets_match_the_reference(n, C):
    from znicz_torch.ops.lrn import _fwd_plan, window_offsets
    from znicz_tpu.ops.lrn_pallas import windowed_channel_sum

    lo, taps = window_offsets(n)
    assert (lo, taps) == (-(n // 2), n)
    p = _fwd_plan(6, C, n, False, SMEM_LIMIT)
    assert (p.lo, p.taps) == (lo, taps)
    sq = np.square(np.random.default_rng(n).normal(size=(6, C))
                   .astype(np.float32))
    want = np.asarray(windowed_channel_sum(sq, n))
    got = _padded_sum(sq, lo, taps, p.pad, p.stride - p.pad - C)
    np.testing.assert_array_equal(got, want)
    # the loop the kernels ran before, -n//2 .. +n//2, sums n + 1
    # channels for an even n
    old = _padded_sum(sq, -(n // 2), 2 * (n // 2) + 1, p.pad + 4,
                      p.stride - p.pad - C + 4)
    assert np.array_equal(old, want) == (n % 2 == 1 or C <= n // 2)


def _check_cover(rows, C, p):
    """Blocks walk equal runs of groups that own every row once; threads
    of a row own every unit once; the block fits 256 threads."""
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
    assert 1 <= p.stages <= 2 and p.smem <= SMEM_LIMIT
    assert p.smem == 4 * (p.stages * p.rows * C + 2 * p.rows * p.stride)
    right = p.stride - p.pad - C
    assert p.pad >= -p.lo and right >= p.lo + p.taps - 1
    if p.vec:
        assert p.pad % 4 == 0 and p.stride % 4 == 0 and C % 4 == 0


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_fwd_plan_at_alexnet_shapes(layer):
    from znicz_torch.ops.lrn import _fwd_plan

    rows, C = ALEXNET[layer]
    p = _fwd_plan(rows, C, 5, True, SMEM_LIMIT, 132)
    _check_cover(rows, C, p)
    # two float4s a thread, n = 5 unrolled from three 16-byte reads: pads
    # of 4; a ring of two; every block resident at once, 6 to an SM
    assert p.vec and p.threads_per_row == C // 8
    assert (p.pad, p.stride - p.pad - C, p.lo, p.taps) == (4, 4, -2, 5)
    assert p.stages == 2 and p.blocks_per_sm == 6
    assert p.blocks <= 132 * p.blocks_per_sm


@pytest.mark.parametrize("rows,C,n,aligned", [
    (97, 33, 5, True),        # scalar: C % 4 != 0; rows no multiple of 7
    (50, 64, 4, True),        # even window
    (40, 64, 5, False),       # unaligned operand: scalar
    (9, 3, 5, True),          # C < n
    (21, 1024, 7, True),      # a row of 128 threads
    (5, 4000, 5, True),       # several units a thread, past 48 KB
    (3, 2050, 1, False),      # several channels a thread, scalar
])
def test_fwd_plan_covers_ragged_shapes(rows, C, n, aligned):
    from znicz_torch.ops.lrn import _fwd_plan

    p = _fwd_plan(rows, C, n, aligned, SMEM_LIMIT)
    _check_cover(rows, C, p)
    assert p.vec == (aligned and C % 4 == 0)
    for n_sms in (1, 7, 1000):
        _check_cover(rows, C, _fwd_plan(rows, C, n, aligned, SMEM_LIMIT,
                                        n_sms))


def test_fwd_plan_shrinks_the_ring_then_refuses():
    from znicz_torch.ops.lrn import _fwd_plan

    assert [_fwd_plan(4, C, 5, True, SMEM_LIMIT).stages
            for C in (13000, 16000)] == [2, 1]
    with pytest.raises(ValueError, match="shared memory"):
        _fwd_plan(4, 20000, 5, True, SMEM_LIMIT)


@pytest.mark.parametrize("shape,n,beta,aligned", [
    ((3, 5, 7, 96), 5, 0.75, True),
    ((2, 3, 5, 13), 4, 0.6, False),
    ((4, 2, 2, 3), 5, 0.75, False),
])
def test_kernel_walk_matches_plain(shape, n, beta, aligned):
    """K3's arithmetic as planned — squares in a row padded to the plan's
    width, taps from ``lo`` in order onto 0, then ``x * pow(k + alpha *
    acc, -beta)`` — is bit-equal to ``lrn_plain``."""
    from znicz_torch.ops.lrn import _fwd_plan, lrn_plain

    x = torch.from_numpy(np.abs(np.random.default_rng(3).normal(
        size=shape) * 3.0).astype(np.float32))
    C = shape[-1]
    p = _fwd_plan(x.numel() // C, C, n, aligned, SMEM_LIMIT)
    acc = torch.from_numpy(_padded_sum((x * x).numpy(), p.lo, p.taps, p.pad,
                                       p.stride - p.pad - C))
    got = x * torch.pow(2.0 + 1e-4 * acc, -beta)
    assert torch.equal(got, lrn_plain(x, n, 1e-4, beta, 2.0))
