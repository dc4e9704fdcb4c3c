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
gives exactly what ``lrn_plain`` gives.

The bf16 K3 runs the same design on 8-channel (16-byte) units where
``ops/lrn._bf16_fwd_plan`` takes the shape, else the simple kernel: its
plan is checked the same way, and a walk of its arithmetic on bf16
tensors — squares written into a +0-padded bf16 row, each window summed
from its first tap, in order, from that row's 32-bit words as the kernel
reads them (the odd taps as ``__byte_perm`` halves of two words), s^nb
read from a table of every bf16 s's power, every operation rounded to
bf16 — gives the bits of ``lrn_plain`` and of the reference's
interpret-mode ``lrn_pallas.lrn``."""

import numpy as np
import pytest
import torch

from test_torch_bf16 import LRN_BF16_CASES, _lrn_operands

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


# -- the bf16 K3's ring: the same design on 8-channel units -------------------

#: bf16 shapes on the main path: AlexNet's conv1 and conv2 outputs (batch
#: 128) and CIFAR10's norm (batch 100), as (rows, C)
BF16_MAIN = dict(ALEXNET, cifar=(100 * 16 * 16, 16))


def _check_bf16_cover(rows, C, p, smem_of, n_sms=132):
    """The ring plan of a bf16 kernel: blocks walk equal runs of groups
    that own every row once; the threads of a row own every 8-channel unit
    once, at most two each; the padded rows reach the window, rounded up to
    16 bytes and no further; the layout is ``smem_of``'s at 2 bytes an
    element and fits; every block is resident at once."""
    from znicz_torch import _build
    from znicz_torch.ops.lrn import _BF16_RING_BLOCKS_PER_SM

    units = C // 8
    assert p.vec and C % 8 == 0
    assert p.threads_per_row * p.rows <= 256
    assert 1 <= p.threads_per_row <= units
    owned = [u for t in range(p.threads_per_row)
             for u in range(t, units, p.threads_per_row)]
    assert sorted(owned) == list(range(units))
    assert -(-units // p.threads_per_row) <= 2
    groups = -(-rows // p.rows)
    walked = [g for b in range(p.blocks)
              for g in range(b * p.groups_per_block,
                             min((b + 1) * p.groups_per_block, groups))]
    assert walked == list(range(groups))
    assert (p.blocks - 1) * p.groups_per_block < groups
    assert 1 <= p.stages <= 2
    assert p.smem == smem_of(p.rows, C, p.stride, p.stages, esize=2) \
        <= SMEM_LIMIT
    assert p.blocks_per_sm == min(_BF16_RING_BLOCKS_PER_SM,
                                  _build.resident_blocks(
                                      p.threads_per_row * p.rows, p.smem,
                                      SMEM_LIMIT)) >= 1
    assert p.blocks <= n_sms * p.blocks_per_sm
    right = p.stride - p.pad - C
    assert p.pad % 8 == 0 and p.stride % 8 == 0
    assert -p.lo <= p.pad < -p.lo + 8
    assert p.lo + p.taps - 1 <= right < p.lo + p.taps - 1 + 8


@pytest.mark.parametrize("layer", sorted(BF16_MAIN))
def test_bf16_plan_takes_the_ring_at_main_path_shapes(layer):
    """AlexNet's conv1 (12 units: 6 threads a row, 42 rows a group) and
    conv2 (32: 16 x 16) and CIFAR10's C 16 (2: one thread a row, 256 rows)
    take the ring; n = 5 is unrolled from pads of 8 channels."""
    from znicz_torch.ops.lrn import _bf16_fwd_plan, _fwd_smem

    rows, C = BF16_MAIN[layer]
    p = _bf16_fwd_plan(rows, C, 5, True, SMEM_LIMIT, 132)
    assert p is not None
    _check_bf16_cover(rows, C, p, _fwd_smem)
    assert (p.threads_per_row, p.rows) == {96: (6, 42), 256: (16, 16),
                                           16: (1, 256)}[C]
    assert (p.pad, p.stride - p.pad - C, p.lo, p.taps) == (8, 8, -2, 5)
    assert p.stages == 2


@pytest.mark.parametrize("n", range(1, 8))
@pytest.mark.parametrize("C", [8, 24, 96])
def test_bf16_plan_rows_reach_the_window(n, C):
    from znicz_torch.ops.lrn import _bf16_fwd_plan, _fwd_smem, \
        window_offsets

    p = _bf16_fwd_plan(50, C, n, True, SMEM_LIMIT)
    assert (p.lo, p.taps) == window_offsets(n)
    _check_bf16_cover(50, C, p, _fwd_smem)


@pytest.mark.parametrize("rows,C,n", [
    (43, 96, 5),              # one row past a group of 42
    (7, 8, 5),                # one unit, part of one group
    (97, 24, 5),              # an odd unit count: 2 threads, 2 + 1 units
    (21, 1024, 7),            # 64 threads a row
    (3, 4096, 5),             # the widest row: 256 threads of two units
    (1, 256, 5),              # one row
])
def test_bf16_plan_covers_ragged_shapes(rows, C, n):
    from znicz_torch.ops.lrn import _bf16_fwd_plan, _fwd_smem

    for n_sms in (1, 7, 132, 1000):
        p = _bf16_fwd_plan(rows, C, n, True, SMEM_LIMIT, n_sms)
        assert p is not None
        _check_bf16_cover(rows, C, p, _fwd_smem, n_sms)


@pytest.mark.parametrize("why,C,aligned,limit", [
    ("C % 8 != 0", 20, True, SMEM_LIMIT),
    ("odd C", 33, True, SMEM_LIMIT),
    ("an operand 2 bytes past 16", 64, False, SMEM_LIMIT),
    ("a row past 4096 channels", 4104, True, SMEM_LIMIT),
    ("no group fits", 1024, True, 4096),
])
def test_bf16_plan_takes_the_simple_kernel(why, C, aligned, limit):
    from znicz_torch.ops.lrn import _bf16_fwd_plan

    assert _bf16_fwd_plan(40, C, 5, aligned, limit) is None, why


def _byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on numpy words: byte i of the result is
    byte ``sel``'s nibble i of the eight bytes of a (0-3) and b (4-7)."""
    src = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(src)
    for i in range(4):
        pick = np.uint64((sel >> (4 * i)) & 7)
        out |= ((src >> (np.uint64(8) * pick)) & np.uint64(0xff)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def _words(row):
    """A padded bf16 row (R, stride) as its 32-bit words (R, stride / 2),
    the lower channel in the low half, as the kernel reads shared
    memory."""
    h = row.contiguous().view(torch.int16).numpy().view(np.uint16)
    return h[:, 0::2].astype(np.uint32) | (h[:, 1::2].astype(np.uint32)
                                           << np.uint32(16))


def _lanes(w):
    """Words (R,) as their two bf16 lanes (R, 2)."""
    h = np.stack([w & 0xffff, w >> 16], -1).astype(np.uint16)
    return torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)


def _pair_at(w, e):
    """Lanes at channels e, e+1 of a padded row of words (``pair_at``)."""
    q = e >> 1
    assert 0 <= e and q + (e & 1) < w.shape[1], "a tap past the padded row"
    return _lanes(_byte_perm(w[:, q], w[:, q + 1], 0x5432) if e & 1
                  else w[:, q])


def _window8(w, e0, lo, taps):
    """``window8``: W_n of channels c .. c+7 (c at element e0 of the
    padded row of words ``w``), (R, 8) bf16, each pair summed from its
    first tap in order, each add rounded.  n = 5 reads channels c-2 ..
    c+9 as six words and takes the odd taps as halves of two; any other
    window reads each tap as a pair."""
    out = []
    if (lo, taps) == (-2, 5):
        q = e0 >> 1
        assert e0 % 2 == 0 and q >= 1 and q + 4 < w.shape[1]
        v = [w[:, q - 1 + j] for j in range(6)]
        for m in range(4):
            s = _lanes(v[m])
            s = s + _lanes(_byte_perm(v[m], v[m + 1], 0x5432))
            s = s + _lanes(v[m + 1])
            s = s + _lanes(_byte_perm(v[m + 1], v[m + 2], 0x5432))
            out.append(s + _lanes(v[m + 2]))
    else:
        for m in range(4):
            e = e0 + 2 * m + lo
            s = _pair_at(w, e)
            for o in range(1, taps):
                s = s + _pair_at(w, e + o)
            out.append(s)
    return torch.cat(out, -1)


def _padded(v, p):
    """``v`` (R, C) written into rows padded with +0 to the plan's
    layout."""
    row = torch.zeros((v.shape[0], p.stride), dtype=v.dtype)
    row[:, p.pad:p.pad + v.shape[1]] = v
    return row


def _units(C, p):
    """Every thread's units of a row, as the channel each starts at."""
    return [c for t in range(p.threads_per_row)
            for c in range(8 * t, C, 8 * p.threads_per_row)]


def _pow_table(nb):
    """The ring kernels' table of powers, on the CPU: ``torch.pow(s, nb)``
    of the bf16 value s whose bits are i, for every i of 16 bits."""
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    return torch.pow(every.view(torch.bfloat16), nb)


def _read(table, s):
    """``inv_pow2``'s reads: each lane's bits index the table."""
    return table[s.view(torch.int16).long() & 0xffff]


def _bf16_fwd_walk(x, n, alpha, beta, k, p):
    """The bf16 K3 ring kernel's arithmetic as planned, on the CPU: squares
    into a +0-padded row, then per unit its windows, s, sb (read from the
    table of powers) and y, every operation a bf16 one (rounded)."""
    from znicz_torch.ops.lrn import operand_constants

    a, kk, nb = operand_constants(torch.bfloat16, alpha, k, -beta)
    table = _pow_table(nb)
    C = x.shape[-1]
    rows = x.reshape(-1, C)
    w = _words(_padded(rows * rows, p))
    y = torch.full_like(rows, float("nan"))
    for c in _units(C, p):
        acc = _window8(w, p.pad + c, p.lo, p.taps)
        sb = _read(table, kk + a * acc)
        y[:, c:c + 8] = rows[:, c:c + 8] * sb
    return y.view(x.shape)


def test_byte_perm_takes_the_high_half_then_the_low():
    """Selector 0x5432 gives the high lane of a then the low lane of b."""
    a, b = np.array([0x22221111], np.uint32), np.array([0x44443333],
                                                        np.uint32)
    assert _byte_perm(a, b, 0x5432)[0] == 0x33332222


@pytest.mark.parametrize("shape,n,alpha,beta,k,scale", LRN_BF16_CASES)
def test_bf16_ring_walk_matches_plain_and_reference(shape, n, alpha, beta, k,
                                                    scale):
    """The walk of the bf16 K3's ring gives the bits of ``lrn_plain`` on
    bf16 tensors and of the reference's ``lrn_pallas.lrn`` (its kernel in
    interpret mode) on the same inputs, in every element."""
    from znicz_torch.ops.lrn import _bf16_fwd_plan, lrn_plain
    from znicz_tpu.ops.lrn_pallas import lrn as jax_lrn

    x, _, tx, _ = _lrn_operands(shape, scale, sum(shape) + n)
    C = shape[-1]
    p = _bf16_fwd_plan(tx.numel() // C, C, n, True, SMEM_LIMIT)
    assert p is not None
    got = _bf16_fwd_walk(tx, n, alpha, beta, k, p)
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy()
    np.testing.assert_array_equal(
        bits, lrn_plain(tx, n, alpha, beta, k).view(torch.int16).numpy())
    np.testing.assert_array_equal(
        bits, np.asarray(jax_lrn(x, n, alpha, beta, k)).view(np.int16))
