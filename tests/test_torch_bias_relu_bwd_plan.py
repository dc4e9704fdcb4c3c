"""K2b's launch (``fused_block._bias_relu_bwd_plan``) on the CPU, and the
bf16 K2's and K2b's routes.

The kernel (``znicz_torch/csrc/bias_relu_bwd.cu``) runs only on the card.
Which rows each block sums, and in what order db adds them up, is planned
in Python from the shape alone, so it is checked here: every row and
channel is owned once, the final sum's splits fit the block, shared
memory stays small; and a numpy walk of the planned partition — each
thread's rows in order, a block's row slots in order, the partial rows
in fixed runs, the runs in order — gives dx bit-equal to the plain
version and db within float32 rounding of the reference's vjp (Pallas
kernel in interpret mode): per channel |d| <= 1e-5 * sum|dx|, the sums
being of a few hundred terms in another order.

The bf16 K2b runs the same kernel on 16-byte units of eight bf16 channels
(``fused_block._bf16_relu_bwd_plan``: the float32 plan at unit width 8),
checked the same way on bf16-rounded inputs: dx, rounded once to bf16,
bit-equal to the plain version, and db against the reference's vjp on
bf16 operands.  Both bf16 wrappers choose between their 16-byte kernel and
the simple one from C and the operands' alignment alone
(``_bf16_relu_fwd_route``, ``_bf16_relu_bwd_plan``)."""

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


def _bf16_plan(rows, C, aligned=True, n_sms=132):
    from znicz_torch.fused_block import _bf16_relu_bwd_plan

    return _bf16_relu_bwd_plan(rows, C, aligned, n_sms)


def _owners(rows, C, p):
    """{(row, unit): (block row, chunk, row slot)} of the plan."""
    from znicz_torch.fused_block import _br_rows

    units = C // p.width
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
    """K2b's schedule in numpy float32: (dx, db), dx before any rounding
    to the operands' dtype.  It holds at any unit width: a unit's channels
    are summed lane by lane, each over its rows in the same order, so the
    width decides which thread owns a channel (:func:`_owners`), not the
    order of its sums."""
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


# -- the bf16 K2b on 16-byte units, and the bf16 routes ------------------------


@pytest.mark.parametrize("rows,C", [
    (3 * 13 * 13, 384), (5 * 9 * 9, 32), (1, 8), (9 * 9, 24), (2, 96),
    (70, 8192), (4 * 16 * 16, 16)])
def test_bf16_plan_owns_every_row_and_unit_once(rows, C):
    p = _bf16_plan(rows, C, n_sms=4)
    own, units = _owners(rows, C, p)
    assert p.vec and p.width == 8 and units == C // 8
    assert len(own) == rows * units
    assert p.chunks * p.threads_per_row >= units \
        > (p.chunks - 1) * p.threads_per_row
    threads = p.threads_per_row * p.rows
    assert threads <= 512 and p.smem == threads * 8 * 4 <= 16384
    assert 1 <= p.row_blocks <= max(1, 4 * 2 // p.chunks)
    assert p.splits == 1 or p.splits * units <= threads
    assert p.splits <= p.row_blocks


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_bf16_plan_at_alexnet_shapes(layer):
    B, H, W, C = ALEXNET[layer]
    p = _bf16_plan(B * H * W, C)
    # eight bf16 a thread, one chunk, two blocks an SM, at most 16 KB
    assert p.vec and p.width == 8 and p.chunks == 1
    assert p.threads_per_row == C // 8
    assert p.row_blocks == 264 and p.smem <= 16384
    assert p.splits == p.threads_per_row * p.rows // (C // 8) > 1


def _bf16_rounded(shape, seed, scale=1.0):
    """Seeded float32 values rounded to bf16, as float32."""
    return torch.from_numpy(_rand(shape, seed, scale)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape", [(4, 13, 13, 384), (3, 9, 9, 32),
                                   (2, 27, 27, 8), (2, 16, 16, 16)])
def test_bf16_schedule_walk_matches_plain_and_reference(shape):
    """The walk of the bf16 plan on bf16 operands: dx rounded once to bf16
    is the plain version's, and db is within DB_RTOL * sum|dx| of the
    reference's vjp on bf16 x and dp.  The reference is given the bias as
    float32 holding the same bf16 values, so that its db comes back before
    its cast to the bias's dtype (``_call_bias_relu_bwd``); its kernel
    widens the bias to float32 first, so the arithmetic is the same."""
    import jax
    import jax.numpy as jnp

    from znicz_torch.fused_block import bias_relu_bwd_plain
    from znicz_tpu.pallas_fused_block import fused_bias_relu as jax_br

    x = _bf16_rounded(shape, 94)
    b = _bf16_rounded(shape[-1:], 95, 0.3)
    dp = _bf16_rounded(shape, 96)
    p = _bf16_plan(int(np.prod(shape[:-1])), shape[-1], n_sms=3)
    assert p.width == 8 and p.row_blocks > 1 and p.splits > 1
    dx, db = _walk(x, b, dp, p)
    xh, bh, dph = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, b, dp))
    pdx, pdb = bias_relu_bwd_plain(xh, bh, dph)
    assert pdx.dtype == torch.bfloat16
    assert torch.equal(torch.from_numpy(dx).to(torch.bfloat16)
                       .view(torch.int16), pdx.view(torch.int16))
    _, vjp = jax.vjp(jax_br, jnp.asarray(x, jnp.bfloat16), jnp.asarray(b))
    _, gb = vjp(jnp.asarray(dp, jnp.bfloat16))
    assert gb.dtype == jnp.float32
    scale = np.abs(dx).reshape(-1, shape[-1]).sum(0)
    assert np.all(np.abs(db - np.asarray(gb)) <= DB_RTOL * scale)
    assert np.all(np.abs(db - pdb.numpy()) <= DB_RTOL * scale)


#: (C, how the operands lie, whether the bf16 K2 and K2b take their
#: 16-byte kernels): C % 8 == 0 and 16-byte aligned operands, else the
#: simple kernels; "2 bytes past" puts x 2 bytes past a 16-byte boundary
ROUTES = [(8, "aligned", True), (16, "aligned", True),
          (96, "aligned", True), (384, "aligned", True),
          (1, "aligned", False), (20, "aligned", False),
          (33, "aligned", False), (64, "2 bytes past", False)]


@pytest.mark.parametrize("kernel", ["bias_relu_bf16_fwd",
                                    "bias_relu_bf16_bwd"])
@pytest.mark.parametrize("C,lie,vec", ROUTES)
def test_bf16_route(kernel, C, lie, vec):
    from znicz_torch.fused_block import (_aligned16, _bf16_relu_bwd_plan,
                                         _bf16_relu_fwd_route)

    shape = (2, 3, 5, C)
    x = torch.zeros(shape, dtype=torch.bfloat16)
    if lie == "2 bytes past":
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(shape)
        assert x.data_ptr() % 16 == 2
    b = torch.zeros((C,), dtype=torch.bfloat16)
    dp = torch.zeros(shape, dtype=torch.bfloat16)
    if kernel == "bias_relu_bf16_fwd":
        route = _bf16_relu_fwd_route(C, _aligned16(x, b))
        assert route == ("bf16x8" if vec else "simple")
    else:
        p = _bf16_relu_bwd_plan(2 * 3 * 5, C, _aligned16(x, b, dp))
        assert (p is not None) == vec
        assert p is None or (p.width == 8 and p.vec)
