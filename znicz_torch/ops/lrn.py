"""Across-channel LRN (port of ``znicz_tpu/ops/lrn_pallas.py``): the
order-sensitive pieces shared with the fused block, the plain versions of
the standalone LRN's forward and backward, the wrappers of their kernels
K3 (``csrc/lrn.cu``) and K3b (``csrc/lrn_bwd.cu``) and of their bf16
operand variants, and :func:`lrn`, the op with the reference's custom vjp.
Like the reference's kernels, both compute in the operand dtype: on bf16
operands every operation rounds to bf16.

    y  = x * s^-beta,  s = k + alpha * W_n(x^2)
    dx = dy * s^-beta - 2*alpha*beta * x * W_n(((dy * x) * s^-beta) / s)

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one, or raises; it counts its launches in
``<wrapper>.launches``.  Both kernels' launches are planned here
(:func:`_fwd_plan`, :func:`_bwd_plan`; for bf16 operands
:func:`_bf16_fwd_plan` and :func:`_bf16_bwd_plan`, the same design on
8-channel units, or the simple kernels, counted apart in
``.simple_launches``), and both take the window as :func:`window_offsets`
gives it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from znicz_torch import _build


def window_offsets(n: int) -> Tuple[int, int]:
    """``(lo, taps)``: the n-channel window takes the offsets ``lo .. lo +
    taps - 1``, ``lo = -(n // 2)``, in that order — for an even n one
    more below the centre than above, as the reference's shifts."""
    n = int(n)
    if n < 1:
        raise ValueError(f"LRN window {n} < 1")
    return -(n // 2), n


def windowed_channel_sum(t, n: int):
    """Sum over the n-channel window centred on the LAST axis (zero past
    the ends), added offset by offset in :func:`window_offsets`' order —
    the reference's shift order, which the kernels repeat."""
    lo, taps = window_offsets(n)
    C = t.shape[-1]
    acc = None
    for o in range(lo, lo + taps):      # acc_c += t_{c+o}
        if o == 0:
            part = t
        else:
            part = torch.zeros_like(t)
            if o > 0:
                part[..., :C - o] = t[..., o:]
            else:
                part[..., -o:] = t[..., :C + o]
        acc = part if acc is None else acc + part
    return acc


def inv_pow_rsqrt(s, beta: float):
    """``s ** -beta``; at beta=0.75 as ``r * sqrt(r)`` with ``r =
    rsqrt(s)``, plain ``pow`` otherwise."""
    if beta == 0.75:
        r = torch.rsqrt(s)
        return r * torch.sqrt(r)
    return torch.pow(s, -beta)


def operand_constants(dtype, *values):
    """``values`` as a ``dtype`` operand's arithmetic takes them: JAX
    rounds a Python constant to a bf16 operand's dtype before it touches
    the operand (weak typing), where PyTorch would use it unrounded in
    float32, so for a dtype narrower than float32 they are rounded to it.
    float32 and wider take them as given, and keep their bits (PyTorch's
    CPU ``pow`` takes a float32 tensor's exponent in double)."""
    if torch.finfo(dtype).bits >= 32:
        return [float(v) for v in values]
    return [float(torch.tensor(v, dtype=dtype)) for v in values]


def lrn_plain(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
              k: float = 2.0):
    """The plain version of K3: ``x * pow(s, -beta)``, with ``pow`` (the
    standalone kernel's own formulation, not the rsqrt form), every
    operation in the operand dtype, as the reference kernel computes: for
    bf16 each product, sum and power rounds to bf16, with alpha, k and
    -beta rounded first (:func:`operand_constants`)."""
    a, kk, nb = operand_constants(x.dtype, alpha, k, -beta)
    s = kk + a * windowed_channel_sum(x * x, n)
    return x * torch.pow(s, nb)


def lrn_bwd_plain(x, dy, n: int = 5, alpha: float = 1e-4,
                  beta: float = 0.75, k: float = 2.0):
    """The plain version of K3b, the reference kernel's arithmetic op by
    op in the operands' dtype: ``s`` recomputed from ``x``, ``t = dy * x *
    sb / s`` (left to right), ``dx = dy * sb - (2 alpha beta) * x *
    W_n(t)``, the constants rounded as in :func:`lrn_plain`."""
    a, kk, nb, c2 = operand_constants(torch.promote_types(x.dtype,
                                                          dy.dtype),
                                      alpha, k, -beta, 2.0 * alpha * beta)
    s = kk + a * windowed_channel_sum(x * x, n)
    sb = torch.pow(s, nb)
    t = dy * x * sb / s
    return dy * sb - c2 * x * windowed_channel_sum(t, n)


def _check(name, *tensors, dtype=torch.float32):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: operands {tuple(t.shape)} on "
                             f"{t.device} and {tuple(x.shape)} on {x.device}")


#: threads a K3 or K3b block may have (``kMaxThreads`` in ``csrc/lrn.cu``
#: and ``csrc/lrn_bwd.cu``)
_THREADS = 256
#: units (16 bytes, or channels) a thread takes of a row where the row has
#: that many: two halve the threads and barriers a row costs
_UNITS = 2
#: most groups in each thread's cp.async ring (``kMaxStages``)
_MAX_STAGES = 2
#: channels of a 16-byte unit: float32 (K3, K3b) and bf16 (their ring
#: variants)
_F32_UNIT, _BF16_UNIT = 4, 8
#: the widest row the bf16 ring kernels take: two units a thread, 256
#: threads a row (``kRingUnits`` in ``csrc/lrn_bf16.cuh``)
_BF16_RING_MAX_C = _BF16_UNIT * _UNITS * _THREADS
#: resident blocks an SM the bf16 ring kernels' launch bounds promise
#: (``kRingBlocksPerSm``): their registers, not their shared memory, cap it
_BF16_RING_BLOCKS_PER_SM = 4


class LrnPlan(NamedTuple):
    """K3's or K3b's launch for one shape: block ``b`` walks groups ``[b *
    groups_per_block, (b + 1) * groups_per_block)`` of ``rows`` pixel rows,
    ``threads_per_row`` threads a row (``csrc/lrn.cu``,
    ``csrc/lrn_bwd.cu``)."""

    vec: bool              # 16-byte units and copies, else one channel
    threads_per_row: int
    rows: int              # pixel rows a group
    blocks: int
    groups_per_block: int
    stages: int            # groups in each thread's cp.async ring
    pad: int               # zeros before a padded row (of squares, of t)
    stride: int            # elements of a padded row, pads included
    smem: int              # dynamic shared memory per block, bytes
    lo: int                # first window offset
    taps: int
    blocks_per_sm: int     # resident blocks per SM


def _fwd_smem(rows, C, stride, stages, esize=4) -> int:
    """K3's shared memory: ``stages`` ring slots of ``rows`` x C elements
    of ``esize`` bytes, then two buffers of ``rows`` rows of squares.  The
    kernel lays them out in that order and takes this size as given."""
    return esize * (stages * rows * C + 2 * rows * stride)


def _bwd_smem(rows, C, stride, stages, esize=4) -> int:
    """K3b's shared memory: ``stages`` ring slots, each ``rows`` x C
    elements of ``esize`` bytes of x then as many of dy, then ``rows`` rows
    of squares and ``rows`` rows of t.  The kernel lays them out in that
    order and takes this size as given."""
    return esize * (2 * stages * rows * C + 2 * rows * stride)


def _plan(kernel, smem_of, rows, C, n, aligned, smem_limit, n_sms,
          unit=_F32_UNIT, max_per_sm=None) -> LrnPlan:
    """The launch both LRN kernels share: a unit of ``unit`` channels, 16
    bytes (C % unit == 0 and 16-byte aligned operands, ``aligned``), or of
    one; two units a thread, up to 256 threads a row and as many rows a
    group as fill 256 threads; padded rows reaching the window (to 16
    bytes); the deepest ring (up to 2 groups) whose layout,
    ``smem_of(rows, C, stride, stages)`` bytes, fits ``smem_limit``; then
    as many blocks as are resident at once on ``n_sms`` SMs (at most
    ``max_per_sm`` an SM), each walking an equal run of groups.  Raises
    ``ValueError`` when one group does not fit."""
    lo, taps = window_offsets(n)
    vec = bool(aligned) and C % unit == 0
    units = C // unit if vec else C
    tpr = min(-(-units // _UNITS), _THREADS)
    r = max(1, _THREADS // tpr)
    pad = -(lo // unit) * unit                # -lo rounded up to a unit
    stride = pad + C + -(-(lo + taps - 1) // unit) * unit
    fitting = [s for s in range(_MAX_STAGES, 0, -1)
               if smem_of(r, C, stride, s) <= smem_limit]
    if not fitting:
        raise ValueError(
            f"{kernel} kernel: a row of {C} floats needs "
            f"{smem_of(r, C, stride, 1)} bytes of shared memory, one "
            f"block may have {smem_limit}")
    stages = fitting[0]
    smem = smem_of(r, C, stride, stages)
    per_sm = _build.resident_blocks(tpr * r, smem, smem_limit)
    if max_per_sm is not None:
        per_sm = min(per_sm, max_per_sm)
    groups = -(-rows // r)
    per_block = max(1, -(-groups // (n_sms * per_sm)))
    return LrnPlan(vec, tpr, r, -(-groups // per_block), per_block, stages,
                   pad, stride, smem, lo, taps, per_sm)


@functools.lru_cache(maxsize=64)
def _fwd_plan(rows, C, n=5, aligned=True, smem_limit=232448,
              n_sms=132) -> LrnPlan:
    """K3's launch (:func:`_plan`, laid out by :func:`_fwd_smem`)."""
    return _plan("lrn", _fwd_smem, rows, C, n, aligned, smem_limit, n_sms)


@functools.lru_cache(maxsize=64)
def _bwd_plan(rows, C, n=5, aligned=True, smem_limit=232448,
              n_sms=132) -> LrnPlan:
    """K3b's launch (:func:`_plan`, laid out by :func:`_bwd_smem`).  A
    thread of a row past 512 units (more than two a thread) keeps x and
    dy * sb in the ring instead of in registers."""
    return _plan("lrn_bwd", _bwd_smem, rows, C, n, aligned, smem_limit,
                 n_sms)


def fwd_plan_for(x, n: int = 5) -> LrnPlan:
    """The :class:`LrnPlan` K3 runs for the CUDA tensor ``x``."""
    C = int(x.shape[-1])
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _fwd_plan(x.numel() // C, C, int(n), x.data_ptr() % 16 == 0,
                     smem_limit, n_sms)


def bwd_plan_for(x, dy, n: int = 5) -> LrnPlan:
    """The :class:`LrnPlan` K3b runs for the CUDA tensors ``x`` and ``dy``
    (``dx`` is allocated aligned)."""
    C = int(x.shape[-1])
    smem_limit, n_sms = _build.device_limits(x.device.index)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return _bwd_plan(x.numel() // C, C, int(n), aligned, smem_limit, n_sms)


def lrn_fwd(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
            k: float = 2.0):
    """Standalone LRN forward over the last axis.  A CPU tensor takes
    :func:`lrn_plain`; a CUDA tensor launches K3 on :func:`_fwd_plan`'s
    launch or raises; bf16 operands go to :func:`lrn_bf16_fwd`."""
    if x.dtype == torch.bfloat16:
        return lrn_bf16_fwd(x, n, alpha, beta, k)
    if x.device.type == "cpu":
        return lrn_plain(x, n, alpha, beta, k)
    _check("lrn_fwd", x)
    p = fwd_plan_for(x, n)
    y = torch.empty_like(x)
    C = int(x.shape[-1])
    rc = _build.entry("lrn")(
        x.data_ptr(), y.data_ptr(), x.numel() // C, C, p.lo, p.taps,
        float(alpha), float(beta), float(k), int(p.vec), p.threads_per_row,
        p.rows, p.stages, p.groups_per_block, p.blocks, p.pad, p.stride,
        p.smem, x.device.index, _build.stream_of(x))
    _build.check(rc, "lrn")
    lrn_fwd.launches += 1
    return y


#: K3 launches since the count was last reset
lrn_fwd.launches = 0


def lrn_bwd(x, dy, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
            k: float = 2.0):
    """Standalone LRN backward: ``dx`` for the forward's input ``x`` and
    the output cotangent ``dy``.  CPU tensors take :func:`lrn_bwd_plain`;
    CUDA tensors launch K3b on :func:`_bwd_plan`'s launch or raise; bf16
    operands go to :func:`lrn_bf16_bwd`."""
    if x.dtype == torch.bfloat16:
        return lrn_bf16_bwd(x, dy, n, alpha, beta, k)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return lrn_bwd_plain(x, dy, n, alpha, beta, k)
    _check("lrn_bwd", x, dy)
    p = bwd_plan_for(x, dy, n)
    dx = torch.empty_like(x)
    C = int(x.shape[-1])
    rc = _build.entry("lrn_bwd")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel() // C, C, p.lo,
        p.taps, float(alpha), float(beta), float(k),
        float(2.0 * alpha * beta), int(p.vec), p.threads_per_row, p.rows,
        p.stages, p.groups_per_block, p.blocks, p.pad, p.stride, p.smem,
        x.device.index, _build.stream_of(x))
    _build.check(rc, "lrn_bwd")
    lrn_bwd.launches += 1
    return dx


#: K3b launches since the count was last reset
lrn_bwd.launches = 0


#: elements of the (rows, C) view a simple bf16 K3 or K3b block takes:
#: whole rows, at least one
_BF16_TILE = 2048


def _bf16_simple_plan(C: int, arrays: int,
                      smem_limit: int) -> Tuple[int, int]:
    """``(rows a block, shared memory in bytes)`` of a simple bf16 K3
    (``arrays`` 2: x and x*x) or K3b (5: x, dy, x*x, t and sb) launch over
    rows of C channels, each array r*C bf16 values (``csrc/lrn_bf16.cuh``).
    Raises ``ValueError`` when one row does not fit ``smem_limit``."""
    r = max(1, _BF16_TILE // C)
    smem = 2 * arrays * r * C
    if smem > smem_limit:
        raise ValueError(f"bf16 LRN kernel: a row of {C} channels needs "
                         f"{smem} bytes of shared memory, one block may "
                         f"have {smem_limit}")
    return r, smem


def _bf16_ring(kernel, smem_of, rows, C, n, aligned, smem_limit,
               n_sms) -> Optional[LrnPlan]:
    """:func:`_plan` on 8-channel (16-byte) units of bf16 rows, laid out by
    ``smem_of`` at 2 bytes an element, at most
    :data:`_BF16_RING_BLOCKS_PER_SM` blocks an SM; or ``None``, and the
    simple kernel runs, for C % 8 != 0, an operand not 16-byte aligned, a
    row wider than :data:`_BF16_RING_MAX_C` or a group that does not fit
    ``smem_limit``."""
    if not (aligned and C % _BF16_UNIT == 0 and C <= _BF16_RING_MAX_C):
        return None
    try:
        return _plan(kernel, functools.partial(smem_of, esize=2), rows, C,
                     n, True, smem_limit, n_sms, _BF16_UNIT,
                     _BF16_RING_BLOCKS_PER_SM)
    except ValueError:
        return None


@functools.lru_cache(maxsize=64)
def _bf16_fwd_plan(rows, C, n=5, aligned=True, smem_limit=232448,
                   n_sms=132) -> Optional[LrnPlan]:
    """The bf16 K3's ring launch (:func:`_bf16_ring`, laid out by
    :func:`_fwd_smem`), or ``None`` for the simple kernel."""
    return _bf16_ring("lrn", _fwd_smem, rows, C, n, aligned, smem_limit,
                      n_sms)


@functools.lru_cache(maxsize=64)
def _bf16_bwd_plan(rows, C, n=5, aligned=True, smem_limit=232448,
                   n_sms=132) -> Optional[LrnPlan]:
    """The bf16 K3b's ring launch (:func:`_bf16_ring`, laid out by
    :func:`_bwd_smem`), or ``None`` for the simple kernel."""
    return _bf16_ring("lrn_bwd", _bwd_smem, rows, C, n, aligned, smem_limit,
                      n_sms)


def bf16_fwd_plan_for(x, n: int = 5) -> Optional[LrnPlan]:
    """The :class:`LrnPlan` the bf16 K3 runs for the CUDA tensor ``x``, or
    ``None`` for the simple kernel."""
    C = int(x.shape[-1])
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _bf16_fwd_plan(x.numel() // C, C, int(n), x.data_ptr() % 16 == 0,
                          smem_limit, n_sms)


def bf16_bwd_plan_for(x, dy, n: int = 5) -> Optional[LrnPlan]:
    """The :class:`LrnPlan` the bf16 K3b runs for the CUDA tensors ``x``
    and ``dy`` (``dx`` is allocated aligned), or ``None`` for the simple
    kernel."""
    C = int(x.shape[-1])
    smem_limit, n_sms = _build.device_limits(x.device.index)
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return _bf16_bwd_plan(x.numel() // C, C, int(n), aligned, smem_limit,
                          n_sms)


#: (device index, nb) -> the bf16 ring kernels' table of powers
_POW_TABLES = {}


def bf16_pow_table(device, nb: float):
    """The table the bf16 ring kernels read s^nb from on CUDA ``device``:
    the 65536 bf16 powers of every bf16 s (its bits the index), filled
    once for each ``nb`` (-beta rounded to bf16) by ``pow_bf16`` itself in
    ``znicz_lrn_bf16_pow_table`` (``csrc/lrn.cu``) and kept."""
    key = (device.index, nb)
    table = _POW_TABLES.get(key)
    if table is None:
        table = torch.empty(65536, dtype=torch.bfloat16, device=device)
        fn = "znicz_lrn_bf16_pow_table"
        rc = _build.entry("lrn", fn)(table.data_ptr(), nb, device.index,
                                     _build.stream_of(table))
        _build.check(rc, "lrn", fn)
        _POW_TABLES[key] = table
    return table


def _bf16_fwd_launch(x, n, alpha, beta, k, plan):
    """Launch the bf16 K3 on ``plan``: the ring kernel, or the simple
    kernel for ``None``."""
    C = int(x.shape[-1])
    a, kk, nb = operand_constants(torch.bfloat16, alpha, k, -beta)
    y = torch.empty_like(x)
    ptrs, shape = (x.data_ptr(), y.data_ptr()), (x.numel() // C, C)
    if plan is None:
        lo, taps = window_offsets(n)
        r, smem = _bf16_simple_plan(C, 2,
                                    _build.device_limits(x.device.index)[0])
        fn = "znicz_lrn_bf16_fwd"
        rc = _build.entry("lrn", fn)(*ptrs, *shape, lo, taps, r, a, kk, nb,
                                     smem, x.device.index,
                                     _build.stream_of(x))
    else:
        fn = "znicz_lrn_bf16_ring_fwd"
        rc = _build.entry("lrn", fn)(
            *ptrs, bf16_pow_table(x.device, nb).data_ptr(), *shape, plan.lo,
            plan.taps, a, kk, plan.threads_per_row, plan.rows, plan.stages,
            plan.groups_per_block, plan.blocks, plan.pad, plan.stride,
            plan.smem, x.device.index, _build.stream_of(x))
    _build.check(rc, "lrn", fn)
    return y


def lrn_bf16_fwd(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 2.0):
    """K3 for bf16 operands (``csrc/lrn.cu``): :func:`lrn_plain`'s
    operations in bf16, each rounded, with its constants.  A CPU tensor
    takes :func:`lrn_plain`; a CUDA tensor launches, on
    :func:`_bf16_fwd_plan`'s choice, K3's ring design on 8-channel units
    (``znicz_lrn_bf16_ring_fwd``) or the simple kernel
    (``znicz_lrn_bf16_fwd``), or raises."""
    if x.device.type == "cpu":
        return lrn_plain(x, n, alpha, beta, k)
    _check("lrn_bf16_fwd", x, dtype=torch.bfloat16)
    plan = bf16_fwd_plan_for(x, n)
    y = _bf16_fwd_launch(x, n, alpha, beta, k, plan)
    lrn_bf16_fwd.launches += 1
    lrn_bf16_fwd.simple_launches += plan is None
    return y


#: bf16 K3 launches since the count was last reset, and those of them that
#: ran the simple kernel
lrn_bf16_fwd.launches = 0
lrn_bf16_fwd.simple_launches = 0


def _bf16_bwd_launch(x, dy, n, alpha, beta, k, plan):
    """Launch the bf16 K3b on ``plan``: the ring kernel, or the simple
    kernel for ``None``."""
    C = int(x.shape[-1])
    a, kk, nb, c2 = operand_constants(torch.bfloat16, alpha, k, -beta,
                                      2.0 * alpha * beta)
    dx = torch.empty_like(x)
    ptrs = (x.data_ptr(), dy.data_ptr(), dx.data_ptr())
    shape = (x.numel() // C, C)
    if plan is None:
        lo, taps = window_offsets(n)
        r, smem = _bf16_simple_plan(C, 5,
                                    _build.device_limits(x.device.index)[0])
        fn = "znicz_lrn_bf16_bwd"
        rc = _build.entry("lrn_bwd", fn)(
            *ptrs, *shape, lo, taps, r, a, kk, nb, c2, smem, x.device.index,
            _build.stream_of(x))
    else:
        fn = "znicz_lrn_bf16_ring_bwd"
        rc = _build.entry("lrn_bwd", fn)(
            *ptrs, bf16_pow_table(x.device, nb).data_ptr(), *shape, plan.lo,
            plan.taps, a, kk, c2, plan.threads_per_row, plan.rows,
            plan.stages, plan.groups_per_block, plan.blocks, plan.pad,
            plan.stride, plan.smem, x.device.index, _build.stream_of(x))
    _build.check(rc, "lrn_bwd", fn)
    return dx


def lrn_bf16_bwd(x, dy, n: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 2.0):
    """K3b for bf16 operands (``csrc/lrn_bwd.cu``): :func:`lrn_bwd_plain`'s
    operations in bf16, each rounded, with its constants.  CPU tensors
    take :func:`lrn_bwd_plain`; CUDA tensors launch, on
    :func:`_bf16_bwd_plan`'s choice, K3b's ring design on 8-channel units
    (``znicz_lrn_bf16_ring_bwd``) or the simple kernel
    (``znicz_lrn_bf16_bwd``), or raise."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return lrn_bwd_plain(x, dy, n, alpha, beta, k)
    _check("lrn_bf16_bwd", x, dy, dtype=torch.bfloat16)
    plan = bf16_bwd_plan_for(x, dy, n)
    dx = _bf16_bwd_launch(x, dy, n, alpha, beta, k, plan)
    lrn_bf16_bwd.launches += 1
    lrn_bf16_bwd.simple_launches += plan is None
    return dx


#: bf16 K3b launches since the count was last reset, and those of them
#: that ran the simple kernel
lrn_bf16_bwd.launches = 0
lrn_bf16_bwd.simple_launches = 0


class _LRN(torch.autograd.Function):
    """The reference's custom vjp: ``x`` is the only residual; the
    backward recomputes ``s`` from it."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hypers = (n, alpha, beta, k)
        return lrn_fwd(x, n, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return (lrn_bwd(x, dy.contiguous(), *ctx.hypers).to(x.dtype),
                None, None, None, None)


def lrn(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0):
    """Standalone LRN with K3 forward and K3b backward (the
    ``pallas_lrn`` routing)."""
    return _LRN.apply(x, int(n), float(alpha), float(beta), float(k))
