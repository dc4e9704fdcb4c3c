"""K2b's launch (``fused_block._bias_relu_bwd_plan``) on the CPU.

The kernel (``znicz_torch/csrc/bias_relu_bwd.cu``) runs only on the card.
Which rows each block sums, and in what order db adds them up, is planned
in Python from the shape alone, so it is checked here: every row and
channel is owned once, the final sum's splits fit the block, shared
memory stays small; and a numpy walk of the planned partition — each
thread's rows in order, a block's row slots in order, the partial rows
in fixed runs, the runs in order — gives dx bit-equal to the plain
version and db within float32 rounding of the reference's vjp (Pallas
kernel in interpret mode): per channel |d| <= 1e-5 * sum|dx|, the sums
being of a few hundred terms in another order."""

import numpy as np
import pytest
import torch

from test_torch_ops import _both, _rand

#: (B, H, W, C) of the bias+ReLU stages at AlexNet's batch 128
ALEXNET = {"conv1": (128, 55, 55, 96), "conv2": (128, 27, 27, 256),
           "conv3": (128, 13, 13, 384), "conv5": (128, 13, 13, 256)}
DB_RTOL = 1e-5


def _plan(rows, C, aligned=True, n_sms=132):
    from znicz_torch.fused_block import _bias_relu_bwd_plan

    return _bias_relu_bwd_plan(rows, C, aligned, n_sms)


def _owners(rows, C, p):
    """{(row, unit): (block row, chunk, row slot)} of the plan."""
    from znicz_torch.fused_block import _br_rows

    units = C // 4 if p.vec else C
    own = {}
    for i in range(p.row_blocks):
        r0, r1 = _br_rows(rows, p.row_blocks, i)
        for j in range(p.chunks):
            for t in range(p.threads_per_row):
                u = j * p.threads_per_row + t
                if u >= units:
                    continue
                for ty in range(p.rows):
                    for row in range(r0 + ty, r1, p.rows):
                        assert (row, u) not in own
                        own[(row, u)] = (i, j, ty)
    return own, units


@pytest.mark.parametrize("rows,C,aligned", [
    (3 * 13 * 13, 384, True), (5 * 9 * 9, 33, True), (1, 1, True),
    (700, 1536, True), (300, 1536, False), (2, 96, True)])
def test_plan_owns_every_row_and_channel_once(rows, C, aligned):
    p = _plan(rows, C, aligned, n_sms=4)
    own, units = _owners(rows, C, p)
    assert len(own) == rows * units
    assert p.vec == (aligned and C % 4 == 0)
    assert p.chunks * p.threads_per_row >= units \
        > (p.chunks - 1) * p.threads_per_row
    threads = p.threads_per_row * p.rows
    assert threads <= 512 and p.smem == threads * (4 if p.vec else 1) * 4
    assert 1 <= p.row_blocks <= max(1, 4 * 2 // p.chunks)
    assert p.splits == 1 or p.splits * units <= threads
    assert p.splits <= p.row_blocks


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_plan_at_alexnet_shapes(layer):
    B, H, W, C = ALEXNET[layer]
    p = _plan(B * H * W, C)
    # a float4 a thread, one chunk, two blocks an SM, at most 8 KB
    assert p.vec and p.chunks == 1 and p.threads_per_row == C // 4
    assert p.row_blocks == 264 and p.smem <= 8192
    assert p.splits == p.threads_per_row * p.rows // (C // 4) > 1


def _walk(x, b, dp, p):
    """K2b's schedule in numpy float32: (dx, db)."""
    from znicz_torch.fused_block import _br_rows

    C = x.shape[-1]
    x2, dp2 = x.reshape(-1, C), dp.reshape(-1, C)
    rows = x2.shape[0]
    dx = dp2 * ((x2 + b) > 0).astype(np.float32)
    partial = np.zeros((p.row_blocks, C), np.float32)
    for i in range(p.row_blocks):
        r0, r1 = _br_rows(rows, p.row_blocks, i)
        slots = np.zeros((p.rows, C), np.float32)
        for ty in range(p.rows):
            for row in range(r0 + ty, r1, p.rows):
                slots[ty] = slots[ty] + dx[row]
        acc = np.zeros(C, np.float32)
        for ty in range(p.rows):
            acc = acc + slots[ty]
        partial[i] = acc
    runs = [np.zeros(C, np.float32) for _ in range(p.splits)]
    for k in range(p.splits):
        for i in range(k * p.row_blocks // p.splits,
                       (k + 1) * p.row_blocks // p.splits):
            runs[k] = runs[k] + partial[i]
    db = np.zeros(C, np.float32)
    for run in runs:
        db = db + run
    return dx.reshape(x.shape), db


@pytest.mark.parametrize("shape", [(4, 13, 13, 384), (3, 9, 9, 33),
                                   (2, 27, 27, 1)])
def test_schedule_walk_matches_plain_and_reference(shape):
    import jax

    from znicz_torch.fused_block import bias_relu_bwd_plain
    from znicz_tpu.pallas_fused_block import fused_bias_relu as jax_br

    x = _rand(shape, 91)
    b = _rand(shape[-1:], 92, 0.3)
    dp = _rand(shape, 93)
    p = _plan(int(np.prod(shape[:-1])), shape[-1], n_sms=3)
    assert p.row_blocks > 1 and p.splits > 1
    dx, db = _walk(x, b, dp, p)
    pdx, _ = bias_relu_bwd_plain(*(torch.from_numpy(a) for a in (x, b, dp)))
    np.testing.assert_array_equal(dx, pdx.numpy())
    jx, jb = _both(x)[0], _both(b)[0]
    _, vjp = jax.vjp(jax_br, jx, jb)
    _, gb = vjp(_both(dp)[0])
    scale = np.abs(dx).reshape(-1, shape[-1]).sum(0)
    assert np.all(np.abs(db - np.asarray(gb)) <= DB_RTOL * scale)
