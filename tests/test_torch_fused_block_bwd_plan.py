"""K1b's schedule (``fused_block._bwd_plan``) on the CPU.

The kernel (``znicz_torch/csrc/fused_block_bwd.cu``) runs only on the
card.  Its schedule is chosen in Python, so it is checked here: the
rectangles of ``dx`` (a strip of rows by a tile of columns) are owned
once each, each reads exactly the rows and columns its pooled windows
need, the shared memory fits one Hopper block, and a plain-PyTorch walk
of the same schedule — rectangle by rectangle, input rows through the
ring in the kernel's order, each row normalised once, each pooled row
pooled once into a running (max, tie count), each band of rows gathered
once its last pooled row is done, window offset (i, j) by (i, j) — gives
exactly what ``fused_block_bwd_plain`` gives on ``dx``, and what the
reference's Pallas kernel (interpret mode) gives within the tolerances
of ``tests/test_torch_ops.py``.  The bf16 K1b runs the same schedule on
2-byte ring rows (``fused_block._bf16_bwd_plan``) where the shape
allows it: the walk on bf16 operands, rows and dp widened at the read,
everything derived float32 and dx rounded once, gives the bits of
``fused_block_bwd_plain`` on them."""

import numpy as np
import pytest
import torch

from test_torch_ops import (ALPHA, BETA, DB_TOL, KERNEL_TOL, K, N, _both,
                            _rand, _tied)

#: one Hopper block's opt-in shared memory (H100: 227 KB)
SMEM_LIMIT = 232448
ALEXNET = {"conv1": (128, 55, 55, 96), "conv2": (128, 27, 27, 256)}
#: each layer's input columns read beyond its width, as the source note
#: of csrc/fused_block_bwd.cu states them: 3 per tile boundary
ALEXNET_HALO = {"conv1": 3 / 55, "conv2": 3 / 27}
RAGGED = [(5, 27, 27, 33, (3, 3, 2, 2)), (3, 13, 13, 20, (3, 3, 2, 2)),
          (1, 7, 9, 1024, (3, 3, 2, 2)), (7, 26, 26, 12, (2, 2, 2, 2)),
          (2, 11, 5, 6, (3, 1, 2, 1)), (4, 9, 9, 8, (1, 1, 4, 4)),
          (1, 3, 3, 4, (3, 3, 2, 2)), (4, 12, 12, 32, (4, 4, 2, 2)),
          (2, 9, 9, 16, (3, 3, 1, 1)), (2, 9, 9, 16, (3, 3, 3, 3)),
          (2, 11, 11, 16, (5, 5, 2, 2))]


def _plan(shape, pool, limit=SMEM_LIMIT, **kw):
    from znicz_torch.fused_block import _bwd_plan

    B, H, W, C = shape
    return _bwd_plan(B, H, W, C, pool, limit, **kw)


def _bf16_plan(shape, pool, limit=SMEM_LIMIT, **kw):
    from znicz_torch.fused_block import _bf16_bwd_plan

    B, H, W, C = shape
    return _bf16_bwd_plan(B, H, W, C, pool, limit, **kw)


def _out_hw(H, W, pool):
    ky, kx, sy, sx = pool
    return (H - ky) // sy + 1, (W - kx) // sx + 1


def _spans(n_out, n_in, k, s, parts):
    from znicz_torch.fused_block import _bwd_span

    return [_bwd_span(n_out, n_in, k, s, parts, j) for j in range(parts)]


def _check_axis(n_out, n_in, k, s, parts):
    """The parts own [0, n_in) once, in order, each a run of whole bands
    of s; each needs exactly the pooled rows whose windows reach its
    rows, and reads exactly those windows' rows and its own.  Returns the
    rows read in all."""
    owned, read = [], 0
    for sp in _spans(n_out, n_in, k, s, parts):
        assert sp.y0 < sp.y1 and sp.y0 % s == 0
        owned.extend(range(sp.y0, sp.y1))
        need = [o for o in range(n_out)
                if o * s < sp.y1 and o * s + k > sp.y0]
        assert list(range(sp.o0, sp.o1)) == need
        rows = set(range(sp.y0, sp.y1))
        for o in need:
            rows.update(range(o * s, o * s + k))
        assert sorted(rows) == list(range(sp.r0, sp.r1))
        assert sp.r1 <= n_in
        read += sp.r1 - sp.r0
    assert owned == list(range(n_in))
    return read


def _check_plan(shape, pool, plan):
    ky, kx, sy, sx = pool
    B, H, W, C = shape
    oh, ow = _out_hw(H, W, pool)
    assert 1 <= plan.n_strips <= -(-H // sy)
    assert 1 <= plan.n_ctiles <= -(-W // sx)
    from znicz_torch.fused_block import _bwd_hold

    assert _bwd_hold(ky, sy) + 1 <= plan.stages <= _bwd_hold(ky, sy) + 2
    _check_axis(oh, H, ky, sy, plan.n_strips)
    return _check_axis(ow, W, kx, sx, plan.n_ctiles)


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_plan_at_alexnet_shapes(layer):
    from znicz_torch.fused_block import _bwd_smem

    shape = ALEXNET[layer]
    pool = (3, 3, 2, 2)
    plan = _plan(shape, pool)
    cols = _check_plan(shape, pool, plan)
    assert plan.vec
    # two blocks an SM, one wave on 132 SMs: each image cut into two
    # rectangles of whole rows, split by columns, as wide rows do not fit
    assert plan.blocks_per_sm == 2
    assert (plan.n_strips, plan.n_ctiles) == (1, 2)
    assert shape[0] * plan.n_strips * plan.n_ctiles <= 132 * 2
    # the layout, for the widest tile, within one block's and half an
    # SM's shared memory
    W, C = shape[2], shape[3]
    tiles = _spans((W - 3) // 2 + 1, W, 3, 2, plan.n_ctiles)
    wt = max(t.r1 - t.r0 for t in tiles)
    owt = max(t.o1 - t.o0 for t in tiles)
    assert plan.smem == _bwd_smem(wt, owt, C, 3, 2, plan.stages, True)
    assert 2 * (plan.smem + 1024) <= SMEM_LIMIT + 1024
    # the halo: 3 columns read twice at the one tile boundary
    assert cols - W == 3
    assert (cols - W) / W == pytest.approx(ALEXNET_HALO[layer])


def test_plan_layout_sizes_at_alexnet():
    """The source note's layout: conv1 tiles of 29 input columns, 5 ring
    rows; conv2 tiles of 15, 4 ring rows."""
    conv1 = _plan(ALEXNET["conv1"], (3, 3, 2, 2))
    conv2 = _plan(ALEXNET["conv2"], (3, 3, 2, 2))
    assert (conv1.stages, conv1.smem) == (5, 96512)
    assert (conv2.stages, conv2.smem) == (4, 113792)


@pytest.mark.parametrize("shape,pool", [(r[:4], r[4]) for r in RAGGED])
def test_plan_covers_ragged_shapes(shape, pool):
    plan = _plan(shape, pool)
    _check_plan(shape, pool, plan)
    assert plan.smem <= SMEM_LIMIT
    assert plan.vec == (shape[3] % 4 == 0)
    slots = 132 * plan.blocks_per_sm
    blocks = shape[0] * plan.n_strips * plan.n_ctiles
    assert blocks <= max(slots, shape[0] * plan.n_ctiles)
    for n_sms in (1, 2, 528, 1000):
        _check_plan(shape, pool, _plan(shape, pool, n_sms=n_sms))


@pytest.mark.parametrize("why,shape,kw", [
    ("odd C", (2, 9, 9, 13), {}),
    ("unaligned", (2, 9, 9, 16), {"aligned": False}),
    ("even window", (2, 9, 9, 16), {"n": 4}),
    ("wide window", (2, 9, 9, 16), {"n": 11}),
])
def test_plan_takes_the_scalar_path(why, shape, kw):
    plan = _plan(shape, (3, 3, 2, 2), **kw)
    assert not plan.vec, why
    _check_plan(shape, (3, 3, 2, 2), plan)


@pytest.mark.parametrize("shape,limit,match", [
    ((1, 7, 9, 1024), 100000, "shared memory"),
    ((2, 27, 27, 256), 20000, "shared memory"),
    ((1, 7, 7, 1025), SMEM_LIMIT, "1024"),
])
def test_plan_refuses_layouts_that_do_not_fit(shape, limit, match):
    with pytest.raises(ValueError, match=match):
        _plan(shape, (3, 3, 2, 2), limit)


def test_plan_falls_back_to_one_block_an_sm():
    """Under a tighter limit conv2 keeps a ring of one row beyond the
    held rows and runs one block an SM, in two waves; under a tighter one
    still it cuts more column tiles."""
    one = _plan(ALEXNET["conv2"], (3, 3, 2, 2), 120000)
    assert (one.blocks_per_sm, one.n_strips, one.n_ctiles, one.stages) \
        == (1, 1, 2, 4)
    assert one.smem <= 120000
    tight = _plan(ALEXNET["conv2"], (3, 3, 2, 2), 60000)
    assert tight.n_ctiles > one.n_ctiles and tight.smem <= 60000


# -- the schedule walked in plain PyTorch ---------------------------------------


def _walk(x, bias, dp, n, alpha, beta, k, pool, plan):
    """K1b's schedule op by op.  Per rectangle: input rows (of ``x``'s
    dtype) enter a ring of ``plan.stages`` slots in order, a slot refilled
    only once its row is released (after its normalising if the block does
    not own it, after its band's gather if it does); each row is widened
    to float32, biased, ReLU'd and normalised once; its kx/sx horizontal
    (max, tie count) is folded into
    each pooled row it reaches — continuing and completing rows first,
    then, after any gather, a row it starts — one of ``_bwd_pool_slots``
    slots; a completed pooled row turns its count into ``g = dp / nt``; a
    band of sy rows is gathered after :func:`_bwd_gather_row`: dy from
    the windows i outer, j inner, then the LRN backward and the gate; dx
    is stored rounded once to ``x``'s dtype, db summed from the float32
    values before that rounding."""
    from znicz_torch.fused_block import (_bwd_gather_row, _bwd_pool_slots,
                                         _bwd_span, _relu_lrn)
    from znicz_torch.ops.lrn import windowed_channel_sum

    ky, kx, sy, sx = pool
    B, H, W, C = x.shape
    oh, ow = _out_hw(H, W, pool)
    nps = _bwd_pool_slots(ky, sy)
    c2 = 2.0 * alpha * beta
    dx = torch.full_like(x, float("nan"))
    da_all = torch.full(x.shape, float("nan"))     # dx before rounding
    bias = bias.float()
    stores = np.zeros((B, H, W), int)
    reads = 0
    for b in range(B):
        for js in range(plan.n_strips):
            R = _bwd_span(oh, H, ky, sy, plan.n_strips, js)
            for jt in range(plan.n_ctiles):
                X = _bwd_span(ow, W, kx, sx, plan.n_ctiles, jt)
                seg = slice(X.r0, X.r1)
                ring = [None] * plan.stages
                state = {"next": R.r0, "gathered": R.y0}

                def released(q, cur):
                    if R.y0 <= q < R.y1:
                        return q < state["gathered"]
                    return q <= cur

                def issue(cur):
                    while state["next"] < R.r1:
                        q = state["next"]
                        old = q - plan.stages
                        if old >= R.r0 and not released(old, cur):
                            break
                        slot = (q - R.r0) % plan.stages
                        assert ring[slot] is None or ring[slot][0] == old
                        ring[slot] = (q, x[b, q, seg])
                        state["next"] += 1

                def row_of(q):
                    got, row = ring[(q - R.r0) % plan.stages]
                    assert got == q
                    return row

                slots = [None] * nps       # (oy, max, count or g)
                mg = R.y0 // sy
                lo = hi = R.o0

                def fold(r, yrow, start_phase):
                    m = cnt = None
                    base = X.o0 * sx - X.r0
                    for jj in range(kx):
                        v = yrow[base + jj:base + jj + (X.o1 - X.o0 - 1) * sx
                                 + 1:sx]
                        if m is None:
                            m, cnt = v, torch.ones_like(v)
                        else:
                            cnt = torch.where(v > m, 1.0, torch.where(
                                v == m, cnt + 1.0, cnt))
                            m = torch.maximum(m, v)
                    for oy in range(lo, hi + 1):
                        d = r - oy * sy
                        if (d == 0 and ky > 1) != start_phase:
                            continue
                        if d == 0:
                            slots[oy % nps] = [oy, m, cnt]
                        else:
                            got, pm, pn = slots[oy % nps]
                            assert got == oy
                            pn = torch.where(m > pm, cnt, torch.where(
                                m == pm, pn + cnt, pn))
                            slots[oy % nps] = [oy, torch.maximum(pm, m), pn]
                        if d == ky - 1:
                            slots[oy % nps][2] = \
                                dp[b, oy, X.o0:X.o1].float() \
                                / slots[oy % nps][2]

                def gather(m):
                    nonlocal reads
                    for y in range(m * sy, min((m + 1) * sy, R.y1)):
                        row = row_of(y)[X.y0 - X.r0:X.y1 - X.r0].float()
                        a, r_, s_, sb = _relu_lrn(row, bias, n, alpha, beta,
                                                  k)
                        yv = r_ * sb
                        dy = torch.zeros_like(row)
                        for xi, xx in enumerate(range(X.y0, X.y1)):
                            i, oy = y - m * sy, m
                            while i < ky and oy >= 0:
                                j, ox = xx % sx, xx // sx
                                while oy < oh and j < kx and ox >= 0:
                                    if ox < ow:
                                        got, pm, g = slots[oy % nps]
                                        assert got == oy
                                        hit = yv[xi] == pm[ox - X.o0]
                                        dy[xi] = dy[xi] + torch.where(
                                            hit, g[ox - X.o0], 0.0)
                                    ox, j = ox - 1, j + sx
                                oy, i = oy - 1, i + sy
                        t = dy * r_ * (sb / s_)
                        dr = dy * sb - c2 * r_ * windowed_channel_sum(t, n)
                        da = dr * (a > 0.0).to(row.dtype)
                        da_all[b, y, X.y0:X.y1] = da
                        dx[b, y, X.y0:X.y1] = da
                        stores[b, y, X.y0:X.y1] += 1

                issue(R.r0 - 1)
                for r in range(R.r0, R.r1):
                    if r > R.r0:
                        if lo * sy + ky - 1 < r:
                            lo += 1
                        if (hi + 1) * sy <= r and hi + 1 < R.o1:
                            hi += 1
                    reads += 1
                    _, rr, _, sb = _relu_lrn(row_of(r).float(), bias, n,
                                             alpha, beta, k)
                    ybuf = rr * sb           # row r normalised, once
                    issue(r)
                    fold(r, ybuf, False)
                    if mg * sy < R.y1 and \
                            _bwd_gather_row(mg, H, oh, ky, sy) <= r:
                        while mg * sy < R.y1 and \
                                _bwd_gather_row(mg, H, oh, ky, sy) <= r:
                            gather(mg)
                            state["gathered"] = min((mg + 1) * sy, R.y1)
                            mg += 1
                        issue(r)
                    fold(r, ybuf, True)
                assert mg * sy >= R.y1 and state["next"] == R.r1
    assert (stores == 1).all()
    return dx, da_all.sum(dim=(0, 1, 2)), reads


SHAPES = [((2, 13, 13, 20), (3, 3, 2, 2)), ((2, 15, 15, 33), (3, 3, 2, 2)),
          ((2, 13, 13, 96), (3, 3, 2, 2)), ((2, 12, 12, 20), (2, 2, 2, 2)),
          ((2, 12, 12, 8), (4, 4, 2, 2)), ((2, 9, 9, 12), (1, 1, 4, 4)),
          ((2, 9, 9, 8), (3, 3, 1, 1)), ((2, 11, 11, 8), (5, 5, 2, 2))]


@pytest.mark.parametrize("shape,pool", SHAPES, ids=[
    "c20_h13", "c33_h15", "c96_h13", "c20_pool2", "c8_pool4x4s2",
    "c12_pool1x1s4", "c8_pool3x3s1", "c8_pool5x5s2"])
@pytest.mark.parametrize("tied", [False, True], ids=["rand", "ties"])
@pytest.mark.parametrize("cut", ["one_block", "strips", "tiles"])
def test_schedule_walk_matches_plain_and_reference(shape, pool, tied, cut):
    import jax

    from znicz_torch.fused_block import BwdPlan, fused_block_bwd_plain
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    x = _tied(shape, 201) if tied else _rand(shape, 201, 2.0)
    b = np.zeros(shape[-1], np.float32) if tied \
        else _rand(shape[-1:], 202, 0.1)
    jx, tx = _both(x)
    jb, tb = _both(b)
    oh, ow = _out_hw(shape[1], shape[2], pool)
    jdp, tdp = _both(_rand((shape[0], oh, ow, shape[3]), 203))
    ky, kx, sy, sx = pool
    plan = _plan(shape, pool, n_sms={"one_block": 1, "strips": 132,
                                     "tiles": 1}[cut])
    if cut == "tiles":        # column tiles as a tight limit would cut them
        plan = BwdPlan(2, min(3, -(-shape[2] // sx)), plan.stages,
                       plan.smem, plan.vec, 1)
    dx, db, reads = _walk(tx, tb, tdp, N, ALPHA, BETA, K, pool, plan)
    want_dx, want_db = fused_block_bwd_plain(tx, tb, tdp, N, ALPHA, BETA, K,
                                             pool)
    np.testing.assert_array_equal(dx.numpy(), want_dx.numpy())
    np.testing.assert_allclose(db.numpy(), want_db.numpy(), **DB_TOL)
    _, vjp = jax.vjp(
        lambda xx, bb: jax_fused_block(xx, bb, N, ALPHA, BETA, K, pool),
        jx, jb)
    gx, gb = vjp(jdp)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **KERNEL_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), **DB_TOL)
    # each input row read once per column tile, plus the halo rows of
    # every strip boundary
    B, H = shape[:2]
    rows = sum(s.r1 - s.r0 for s in _spans(oh, H, ky, sy, plan.n_strips))
    assert reads == B * plan.n_ctiles * rows
    if tied:
        assert (want_dx == 0).any()               # ReLU zeros reached dx


# -- the bf16 K1b: the same ring on 2-byte rows --------------------------------


@pytest.mark.parametrize("layer", sorted(ALEXNET))
def test_bf16_plan_at_alexnet_shapes(layer):
    """AlexNet's bf16 operands take the ring on 2-byte rows, planned by
    the float32 rules on the smaller rows: two blocks an SM, one wave,
    the layout of half-width ring rows beside the float32 row buffer,
    maxima, g and t."""
    from znicz_torch.fused_block import _bwd_smem

    shape = ALEXNET[layer]
    pool = (3, 3, 2, 2)
    plan = _bf16_plan(shape, pool)
    assert plan is not None and plan.vec
    _check_plan(shape, pool, plan)
    assert plan.blocks_per_sm == 2 and plan.smem <= SMEM_LIMIT
    assert shape[0] * plan.n_strips * plan.n_ctiles <= 132 * 2
    W, C = shape[2], shape[3]
    tiles = _spans((W - 3) // 2 + 1, W, 3, 2, plan.n_ctiles)
    wt = max(t.r1 - t.r0 for t in tiles)
    owt = max(t.o1 - t.o0 for t in tiles)
    assert plan.smem == _bwd_smem(wt, owt, C, 3, 2, plan.stages, True, 2)
    assert 2 * (plan.smem + 1024) <= SMEM_LIMIT + 1024
    # the rules' choice on half-width rows: conv1 whole rows in two strips,
    # conv2 two column tiles with a ring one row deeper than float32's
    f32 = _plan(shape, pool)
    if layer == "conv1":
        assert (plan.n_strips, plan.n_ctiles, plan.stages) == (2, 1, 4)
    else:
        assert (plan.n_strips, plan.n_ctiles) == (f32.n_strips, f32.n_ctiles)
        assert plan.stages == f32.stages + 1


@pytest.mark.parametrize("why,shape,kw", [
    ("C % 8 != 0", (2, 9, 9, 20), {}),
    ("odd C", (2, 9, 9, 13), {}),
    ("2-byte offset", (2, 9, 9, 16), {"aligned": False}),
    ("even window", (2, 9, 9, 16), {"n": 4}),
    ("wide window", (2, 9, 9, 16), {"n": 11}),
    ("C > 1024", (1, 7, 7, 1032), {}),
])
def test_bf16_plan_takes_the_simple_kernels(why, shape, kw):
    assert _bf16_plan(shape, (3, 3, 2, 2), **kw) is None, why


def test_bf16_plan_takes_the_simple_kernels_where_no_layout_fits():
    assert _bf16_plan((2, 27, 27, 256), (3, 3, 2, 2), 20000) is None
    assert _bf16_plan((2, 27, 27, 256), (3, 3, 2, 2), 40000) is not None


def _rounds_within(ref, value, tol):
    """Assert that each element of ``ref`` (the reference's bf16 result)
    is the bf16 rounding of a value within ``tol`` of the float32
    ``value`` (the plain version's before its one rounding).  Both
    packages compute in float32 within the tolerance and round once to
    bf16; where that band holds a rounding boundary, either neighbour is
    the right answer, elsewhere only the one."""
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    span = tol["atol"] + tol["rtol"] * value.abs()
    lo = (value - span).to(torch.bfloat16).float()
    hi = (value + span).to(torch.bfloat16).float()
    bad = ~((lo <= ref) & (ref <= hi))
    assert not bad.any(), (f"{int(bad.sum())} of {ref.numel()}: reference "
                           f"{ref[bad][:4]}, plain before rounding "
                           f"{value[bad][:4]}")


#: (shape, pool, cut): the float32 walk's shapes with C % 8 == 0, C 16 or
#: 32 in place of C 12, 20 and 33, each under one of the three cuts
BF16_SHAPES = [((2, 13, 13, 16), (3, 3, 2, 2), "tiles"),
               ((2, 15, 15, 32), (3, 3, 2, 2), "strips"),
               ((2, 13, 13, 96), (3, 3, 2, 2), "one_block"),
               ((2, 12, 12, 32), (2, 2, 2, 2), "tiles"),
               ((2, 12, 12, 8), (4, 4, 2, 2), "strips"),
               ((2, 9, 9, 16), (1, 1, 4, 4), "one_block"),
               ((2, 9, 9, 8), (3, 3, 1, 1), "tiles"),
               ((2, 11, 11, 8), (5, 5, 2, 2), "strips")]


@pytest.mark.parametrize("shape,pool,cut", BF16_SHAPES, ids=[
    "c16_h13", "c32_h15", "c96_h13", "c32_pool2", "c8_pool4x4s2",
    "c16_pool1x1s4", "c8_pool3x3s1", "c8_pool5x5s2"])
@pytest.mark.parametrize("tied", [False, True], ids=["rand", "ties"])
def test_bf16_schedule_walk_matches_plain_and_reference(shape, pool, cut,
                                                        tied):
    """The walk on bf16 operands (2-byte ring rows and dp widened at the
    read, dx rounded once, db from the unrounded values) has the dx bits
    of ``fused_block_bwd_plain`` on them and its db within DB_TOL, and
    the reference's interpret-mode kernel on the same bf16 inputs is
    within the kernel tolerances of the plain version before its one
    rounding (:func:`_rounds_within`)."""
    import jax
    import jax.numpy as jnp

    from znicz_torch.fused_block import BwdPlan, fused_block_bwd_plain
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    bf16 = torch.bfloat16
    x = _tied(shape, 211) if tied else _rand(shape, 211, 2.0)
    b = np.zeros(shape[-1], np.float32) if tied \
        else _rand(shape[-1:], 212, 0.1)
    oh, ow = _out_hw(shape[1], shape[2], pool)
    dp = _rand((shape[0], oh, ow, shape[3]), 213)
    tx, tb, tdp = (torch.from_numpy(a).to(bf16) for a in (x, b, dp))
    jx, jb, jdp = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                   for t in (tx, tb, tdp))
    ky, kx, sy, sx = pool
    plan = _bf16_plan(shape, pool, n_sms={"one_block": 1, "strips": 132,
                                          "tiles": 1}[cut])
    assert plan is not None and plan.vec
    if cut == "tiles":        # column tiles as a tight limit would cut them
        plan = BwdPlan(2, min(3, -(-shape[2] // sx)), plan.stages,
                       plan.smem, plan.vec, 1)
    dx, db, reads = _walk(tx, tb, tdp, N, ALPHA, BETA, K, pool, plan)
    want_dx, want_db = fused_block_bwd_plain(tx, tb, tdp, N, ALPHA, BETA, K,
                                             pool)
    assert dx.dtype == want_dx.dtype == bf16
    assert db.dtype == want_db.dtype == torch.float32
    assert torch.equal(dx.view(torch.int16), want_dx.view(torch.int16))
    np.testing.assert_allclose(db.numpy(), want_db.numpy(), **DB_TOL)
    _, vjp = jax.vjp(
        lambda xx, bb: jax_fused_block(xx, bb, N, ALPHA, BETA, K, pool),
        jx, jb)
    gx, gb = vjp(jdp)
    # the reference rounds dx and db (to the bias's dtype, in its
    # _call_bwd) once from float32
    assert gx.dtype == gb.dtype == jnp.bfloat16
    dx32, db32 = fused_block_bwd_plain(tx.float(), tb.float(), tdp.float(),
                                       N, ALPHA, BETA, K, pool)
    assert torch.equal(dx32.to(bf16).view(torch.int16),
                       dx.view(torch.int16))
    _rounds_within(gx, dx32, KERNEL_TOL)
    _rounds_within(gb, db32, DB_TOL)
    B, H = shape[:2]
    rows = sum(s.r1 - s.r0 for s in _spans(oh, H, ky, sy, plan.n_strips))
    assert reads == B * plan.n_ctiles * rows
    if tied:
        assert (want_dx == 0).any()               # ReLU zeros reached dx
