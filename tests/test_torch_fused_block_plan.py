"""K1's schedule (``fused_block._fwd_plan``) on the CPU.

The kernel (``znicz_torch/csrc/fused_block.cu``) runs only on the card.
Its schedule is chosen in Python, so it is checked here: the strips
cover every pooled row once, each strip reads its halo, the shared
memory fits one Hopper block, and a plain-PyTorch walk of the same
schedule — strip by strip, row through the ring, bias+ReLU+LRN once per
input row, the horizontal max folded into a running vertical max —
gives exactly what ``fused_block_plain`` gives, and what the reference's
Pallas kernel (interpret mode) gives within the kernel tolerance of
``tests/test_torch_ops.py``.  The bf16 K1 runs the same schedule on
2-byte ring rows (``fused_block._bf16_fwd_plan``) where the shape allows
it: the walk on bf16 operands, rows widened at the read and the output
rounded once, gives the bits of ``fused_block_plain`` on them."""

import numpy as np
import pytest
import torch

from test_torch_ops import ALPHA, BETA, KERNEL_TOL, K, N, _both, _rand, _tied

#: one Hopper block's opt-in shared memory (H100: 227 KB)
SMEM_LIMIT = 232448
ALEXNET = {"conv1": (128, 55, 55, 96), "conv2": (128, 27, 27, 256)}
RAGGED = [(5, 27, 27, 33, (3, 3, 2, 2)), (3, 13, 13, 20, (3, 3, 2, 2)),
          (1, 7, 9, 1024, (3, 3, 2, 2)), (7, 26, 26, 12, (2, 2, 2, 2)),
          (2, 11, 5, 6, (3, 1, 2, 1)), (4, 9, 9, 8, (1, 1, 4, 4)),
          (1, 3, 3, 4, (3, 3, 2, 2))]


def _plan(shape, pool, **kw):
    from znicz_torch.fused_block import _fwd_plan

    B, H, W, C = shape
    return _fwd_plan(B, H, W, C, pool, SMEM_LIMIT, **kw)


def _bf16_plan(shape, pool, **kw):
    from znicz_torch.fused_block import _bf16_fwd_plan

    B, H, W, C = shape
    return _bf16_fwd_plan(B, H, W, C, pool, kw.pop("limit", SMEM_LIMIT), **kw)


def _out_hw(H, W, pool):
    ky, kx, sy, sx = pool
    return (H - ky) // sy + 1, (W - kx) // sx + 1


def _check_cover(shape, pool, plan):
    """Strips tile [0, OH) in order; each reads the ky-row windows of its
    pooled rows and nothing more; the ring never outgrows a strip."""
    from znicz_torch.fused_block import _fwd_strip

    ky, _, sy, _ = pool
    oh, _ = _out_hw(shape[1], shape[2], pool)
    assert 1 <= plan.n_strips <= oh
    seen, longest = [], 0
    for j in range(plan.n_strips):
        oy0, oy1, r0, r1 = _fwd_strip(oh, plan.n_strips, j, ky, sy)
        assert oy0 < oy1
        seen.extend(range(oy0, oy1))
        assert r0 == oy0 * sy and r1 == (oy1 - 1) * sy + ky <= shape[1]
        longest = max(longest, r1 - r0)
    assert seen == list(range(oh))
    assert 1 <= plan.stages <= min(3, longest)


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_plan_at_alexnet_shapes(layer):
    from znicz_torch.fused_block import _fwd_smem, _fwd_strip

    shape = ALEXNET[layer]
    plan = _plan(shape, (3, 3, 2, 2))
    _check_cover(shape, (3, 3, 2, 2), plan)
    assert plan.vec and plan.smem <= SMEM_LIMIT
    # two blocks an SM; one wave on 132 SMs: every block resident, and
    # one more strip an image would not be
    slots = 132 * plan.blocks_per_sm
    assert plan.blocks_per_sm >= 2
    assert shape[0] * plan.n_strips <= slots < shape[0] * (plan.n_strips + 1)
    # the layout: mbarriers, the ring, the normalised row, the maxima
    W, C = shape[2], shape[3]
    ow = (W - 3) // 2 + 1
    assert plan.smem == _fwd_smem(W, C, ow, 3, 2, plan.stages) \
        == 128 + (plan.stages + 1) * W * C * 4 + 2 * ow * C * 4
    # the halo rows re-read: at most 5% more than the input
    rows = sum(r1 - r0 for _, _, r0, r1 in (
        _fwd_strip(ow, plan.n_strips, j, 3, 2)
        for j in range(plan.n_strips)))
    assert rows <= 1.05 * shape[1]


@pytest.mark.parametrize("shape,pool", [(r[:4], r[4]) for r in RAGGED])
def test_plan_covers_ragged_shapes(shape, pool):
    plan = _plan(shape, pool)
    _check_cover(shape, pool, plan)
    assert plan.smem <= SMEM_LIMIT
    assert plan.vec == (shape[3] % 4 == 0)
    for n_sms in (1, 2, 528, 1000):
        _check_cover(shape, pool, _plan(shape, pool, n_sms=n_sms))


@pytest.mark.parametrize("why,shape,kw", [
    ("odd C", (2, 9, 9, 13), {}),
    ("unaligned", (2, 9, 9, 16), {"aligned": False}),
    ("even window", (2, 9, 9, 16), {"n": 4}),
    ("wide window", (2, 9, 9, 16), {"n": 11}),
])
def test_plan_takes_the_scalar_path(why, shape, kw):
    plan = _plan(shape, (3, 3, 2, 2), **kw)
    assert not plan.vec, why
    _check_cover(shape, (3, 3, 2, 2), plan)


@pytest.mark.parametrize("shape,limit,match", [
    ((1, 7, 4000, 16), SMEM_LIMIT, "shared memory"),
    ((2, 27, 27, 256), 40000, "shared memory"),
    ((1, 7, 7, 1025), SMEM_LIMIT, "1024"),
])
def test_plan_refuses_rows_that_do_not_fit(shape, limit, match):
    from znicz_torch.fused_block import _fwd_plan

    B, H, W, C = shape
    with pytest.raises(ValueError, match=match):
        _fwd_plan(B, H, W, C, (3, 3, 2, 2), limit)


def test_plan_shrinks_the_ring_before_giving_up_a_block():
    """conv1 keeps three ring stages and conv2 two, where three would
    leave one block an SM; under a tight limit one stage still runs."""
    conv1 = _plan(ALEXNET["conv1"], (3, 3, 2, 2))
    conv2 = _plan(ALEXNET["conv2"], (3, 3, 2, 2))
    assert (conv1.stages, conv1.blocks_per_sm) == (3, 2)
    assert (conv2.stages, conv2.blocks_per_sm) == (2, 2)
    from znicz_torch.fused_block import _fwd_plan

    tight = _fwd_plan(128, 27, 27, 256, (3, 3, 2, 2), 90000)
    assert (tight.stages, tight.blocks_per_sm) == (1, 1)


# -- the schedule walked in plain PyTorch ---------------------------------------


def _walk(x, bias, n, alpha, beta, k, pool, plan):
    """K1's schedule op by op: per strip, input rows (of ``x``'s dtype)
    enter a ring of ``plan.stages`` slots in order; each row is widened
    to float32, biased, ReLU'd and normalised once, its kx/sx horizontal
    max folded into the float32 running max of each pooled row it
    reaches, one of ceil(ky/sy) slots; a pooled row is stored, rounded
    once to ``x``'s dtype, when its last input row is done."""
    from znicz_torch.fused_block import _fwd_strip, _relu_lrn

    ky, kx, sy, sx = pool
    B, H, W, C = x.shape
    oh, ow = _out_hw(H, W, pool)
    nacc = -(-ky // sy)
    out = torch.full((B, oh, ow, C), float("nan"), dtype=x.dtype)
    stores = np.zeros((B, oh), int)
    reads = 0
    for b in range(B):
        for j in range(plan.n_strips):
            oy0, oy1, r0, r1 = _fwd_strip(oh, plan.n_strips, j, ky, sy)
            ring = [None] * plan.stages
            for s in range(min(plan.stages, r1 - r0)):
                ring[s] = (r0 + s, x[b, r0 + s])
            acc = [None] * nacc
            for i in range(r1 - r0):
                r = r0 + i
                got_r, row = ring[i % plan.stages]
                assert got_r == r
                reads += 1
                _, rr, _, sb = _relu_lrn(row.float(), bias.float(), n,
                                         alpha, beta, k)
                y = rr * sb                                   # (W, C)
                if r + plan.stages < r1:
                    ring[i % plan.stages] = (r + plan.stages,
                                             x[b, r + plan.stages])
                m = None
                for dx in range(kx):
                    win = y[dx:dx + (ow - 1) * sx + 1:sx]
                    m = win if m is None else torch.maximum(m, win)
                lo = max(oy0, -(-(r - ky + 1) // sy))
                for oy in range(lo, min(oy1 - 1, r // sy) + 1):
                    dy = r - oy * sy
                    slot = oy % nacc
                    acc[slot] = m if dy == 0 else torch.maximum(acc[slot], m)
                    if dy == ky - 1:
                        out[b, oy] = acc[slot]
                        stores[b, oy] += 1
    assert (stores == 1).all()
    return out, reads


@pytest.mark.parametrize("shape,pool", [
    ((2, 13, 13, 20), (3, 3, 2, 2)),
    ((2, 27, 27, 33), (3, 3, 2, 2)),
    ((2, 13, 13, 96), (3, 3, 2, 2)),
    ((2, 12, 12, 20), (2, 2, 2, 2)),
    ((2, 26, 26, 33), (2, 2, 2, 2)),
    ((2, 12, 12, 96), (2, 2, 2, 2)),
], ids=["c20_h13", "c33_h27", "c96_h13", "c20_h12_pool2", "c33_h26_pool2",
        "c96_h12_pool2"])
@pytest.mark.parametrize("tied", [False, True], ids=["rand", "ties"])
@pytest.mark.parametrize("n_sms", [1, 132], ids=["long_strips",
                                                 "short_strips"])
def test_schedule_walk_matches_plain_and_reference(shape, pool, tied, n_sms):
    from znicz_torch.fused_block import fused_block_plain
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    x = _tied(shape, 101) if tied else _rand(shape, 101, 2.0)
    b = np.zeros(shape[-1], np.float32) if tied \
        else _rand(shape[-1:], 102, 0.1)
    jx, tx = _both(x)
    jb, tb = _both(b)
    plan = _plan(shape, pool, n_sms=n_sms)
    got, reads = _walk(tx, tb, N, ALPHA, BETA, K, pool, plan)
    want = fused_block_plain(tx, tb, N, ALPHA, BETA, K, pool)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = jax_fused_block(jx, jb, N, ALPHA, BETA, K, pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)
    # each input row read once, plus the ky - sy halo rows per boundary
    ky, _, sy, _ = pool
    B, H = shape[:2]
    assert reads == B * (H + (plan.n_strips - 1) * (ky - sy))


# -- the bf16 K1: the same ring on 2-byte rows ---------------------------------


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_bf16_plan_at_alexnet_shapes(layer):
    """AlexNet's bf16 operands take the ring on 2-byte rows: two blocks an
    SM, one wave, the layout of half-width ring rows beside the float32
    row buffer and maxima."""
    from znicz_torch.fused_block import _fwd_smem

    shape = ALEXNET[layer]
    plan = _bf16_plan(shape, (3, 3, 2, 2))
    assert plan is not None and plan.vec
    _check_cover(shape, (3, 3, 2, 2), plan)
    assert plan.smem <= SMEM_LIMIT and plan.blocks_per_sm == 2
    slots = 132 * plan.blocks_per_sm
    assert shape[0] * plan.n_strips <= slots < shape[0] * (plan.n_strips + 1)
    W, C = shape[2], shape[3]
    ow = (W - 3) // 2 + 1
    assert plan.smem == _fwd_smem(W, C, ow, 3, 2, plan.stages, 2) \
        == 128 + plan.stages * -(-W * C * 2 // 128) * 128 \
        + -(-W * C * 4 // 128) * 128 + 2 * ow * C * 4
    # half-width rows: a ring at least as deep as float32's, in less room
    f32 = _plan(shape, (3, 3, 2, 2))
    assert plan.stages >= f32.stages and plan.smem < f32.smem


@pytest.mark.parametrize("why,shape,kw", [
    ("C % 8 != 0", (2, 9, 9, 20), {}),
    ("odd C", (2, 9, 9, 13), {}),
    ("2-byte offset", (2, 9, 9, 16), {"aligned": False}),
    ("even window", (2, 9, 9, 16), {"n": 4}),
    ("wide window", (2, 9, 9, 16), {"n": 11}),
    ("C > 1024", (1, 7, 7, 1032), {}),
    ("ring row too wide", (1, 7, 8000, 16), {}),
])
def test_bf16_plan_takes_the_simple_kernel(why, shape, kw):
    assert _bf16_plan(shape, (3, 3, 2, 2), **kw) is None, why


@pytest.mark.parametrize("shape,pool", [
    ((2, 13, 13, 32), (3, 3, 2, 2)),
    ((2, 27, 27, 16), (3, 3, 2, 2)),
    ((2, 13, 13, 96), (3, 3, 2, 2)),
    ((2, 12, 12, 16), (2, 2, 2, 2)),
    ((2, 12, 12, 96), (2, 2, 2, 2)),
], ids=["c32_h13", "c16_h27", "c96_h13", "c16_h12_pool2", "c96_h12_pool2"])
@pytest.mark.parametrize("tied", [False, True], ids=["rand", "ties"])
def test_bf16_schedule_walk_matches_plain_and_reference(shape, pool, tied):
    """The walk on bf16 operands (2-byte ring rows widened at the read,
    the output rounded once) has the bits of ``fused_block_plain`` on
    them, and matches the reference's interpret-mode kernel on the same
    bf16 inputs within the kernel tolerance."""
    import jax.numpy as jnp

    from znicz_torch.fused_block import fused_block_plain
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    bf16 = torch.bfloat16
    x = _tied(shape, 111) if tied else _rand(shape, 111, 2.0)
    b = np.zeros(shape[-1], np.float32) if tied \
        else _rand(shape[-1:], 112, 0.1)
    tx, tb = (torch.from_numpy(a).to(bf16) for a in (x, b))
    jx, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tx, tb))
    # short strips at conv1's width, long ones elsewhere
    plan = _bf16_plan(shape, pool, n_sms=132 if shape[1] == 27 else 1)
    assert plan is not None and plan.vec
    got, reads = _walk(tx, tb, N, ALPHA, BETA, K, pool, plan)
    want = fused_block_plain(tx, tb, N, ALPHA, BETA, K, pool)
    assert got.dtype == want.dtype == bf16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    ref = jax_fused_block(jx, jb, N, ALPHA, BETA, K, pool)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **KERNEL_TOL)
    ky, _, sy, _ = pool
    B, H = shape[:2]
    assert reads == B * (H + (plan.n_strips - 1) * (ky - sy))
