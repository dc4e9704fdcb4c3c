"""The fused conv-block and tail stages (port of
``znicz_tpu/pallas_fused_block.py``).

  - :func:`fused_block` — bias + StrictRELU + LRN + exactly-tiling
    max-pool, conv1/conv2 of AlexNet: kernel K1 forward
    (``csrc/fused_block.cu``), K1b backward (``csrc/fused_block_bwd.cu``);
  - :func:`fused_bias_relu` — ``relu(x + b)``, conv3-5: kernel K2 forward
    (``csrc/bias_relu.cu``), K2b backward (``csrc/bias_relu_bwd.cu``);
  - :func:`fused_fc_epilogue` — the FC layers' bias + StrictRELU
    (+ inverted dropout in training), and :func:`fused_softmax_xent`, the
    softmax-CE loss head: plain PyTorch, as the reference's are XLA
    custom vjps, not kernels.

Each op is a ``torch.autograd.Function`` with the reference's custom vjp:
the residual is the stage's input and bias only, and the backward
recomputes the ReLU gate, the LRN and the pool's window maxima (and the
dropout mask, from its seed) instead of loading them.

Each kernel wrapper (``*_fwd``, ``*_bwd``) takes its plain version
(``*_plain``) for CPU tensors and launches its kernel for CUDA tensors,
or raises; it counts its launches in ``<wrapper>.launches``.  The plain
backward versions write the reference's backward out op by op: its
equal split of ``dp`` among tied maxima and its strict ReLU gate
``a > 0`` are not what autograd of the plain forward would give.

bf16 operands (``compute_dtype`` bf16) go to the bf16 wrappers
(``*_bf16_fwd``, ``*_bf16_bwd``), which launch the bf16 entry points of
the same CUDA sources and count their own launches.  As the TPU kernels
do, they compute in float32 and round the output and dx once to bf16;
the plain versions do the same for any operand dtype.  The bias
gradient comes out of a kernel in float32, and ``fused_block_bwd`` and
``bias_relu_bwd`` cast it to the bias's dtype, as the reference's
``_call_bwd`` does.

The planners decide where the fused stages engage, on the same knobs as
the reference: ``root.common.engine.fused_elementwise`` (blocks; stepped
aside for by the LRN-formulation knobs ``lrn_pow``/``lrn_autodiff``/
``pallas_lrn``) and ``fused_tail`` (conv bias+ReLU, FC epilogues, the
position-wise FFN's epilogue (``seq_epilogue``: the FC epilogue on a
per-token product, no dropout) and the loss head).  Both are off by
default.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from znicz_torch import _build
from znicz_torch.core.config import root
from znicz_torch.ops.lrn import inv_pow_rsqrt, windowed_channel_sum


class FusedBlockSpec(NamedTuple):
    """One matched conv-block occurrence in a forwards list."""

    span: int                      # modules consumed
    n: int                         # LRN channel window
    alpha: float
    beta: float
    k: float
    pool: Tuple[int, int, int, int]   # (ky, kx, sy, sx)


class FusedTailSpec(NamedTuple):
    """One matched tail-stage occurrence in a forwards list."""

    kind: str    # "conv_bias_relu" | "fc_epilogue" | "seq_epilogue"
    span: int                  # modules consumed
    ratio: float = 0.0         # dropout ratio (fc_epilogue only)
    dropout_index: int = -1    # forwards index of the absorbed dropout


def _check_kernel_operands(name, x, bias, *others, dtype=torch.float32):
    """Raise unless ``x`` is a contiguous NHWC CUDA tensor of ``dtype``
    with a matching bias, and every tensor of ``others`` is a contiguous
    tensor of ``dtype`` on the same device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != dtype or bias.dtype != dtype:
        raise TypeError(f"{name} kernel takes {dtype}, got {x.dtype}/"
                        f"{bias.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)}")
    if tuple(bias.shape) != (x.shape[-1],) or bias.device != x.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on "
                         f"{bias.device} does not match {tuple(x.shape)} "
                         f"on {x.device}")
    for t in others:
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name} kernel takes contiguous {dtype} "
                             f"operands on {x.device}, got {t.dtype} on "
                             f"{t.device}")


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# -- K1 / K1b: the conv block --------------------------------------------------


def _pool_out_hw(h, w, ky, kx, sy, sx):
    return (h - ky) // sy + 1, (w - kx) // sx + 1


def _pool_windows(y, ky, kx, sy, sx, oh, ow):
    """The ky*kx strided (B, OH, OW, C) window views, i outer, j inner."""
    return [y[:, i:i + (oh - 1) * sy + 1:sy, j:j + (ow - 1) * sx + 1:sx, :]
            for i in range(ky) for j in range(kx)]


def _relu_lrn(x, bias, n, alpha, beta, k):
    """The pre-pool part both directions share: a, r, s, s^-beta."""
    a = x + bias
    r = torch.clamp_min(a, 0.0)
    s = k + alpha * windowed_channel_sum(r * r, n)
    return a, r, s, inv_pow_rsqrt(s, beta)


def fused_block_plain(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                      pool=(3, 3, 2, 2)):
    """The plain version of K1, the reference kernel's arithmetic op by
    op: ``r = relu(x + b)``, ``y = r * inv_pow_rsqrt(k + alpha *
    W_n(r*r))``, then the max over the ky*kx strided windows.  In float32
    whatever the operands' dtype, as the TPU kernel computes: bf16
    operands are widened and the result rounded once to ``x``'s dtype."""
    dtype = x.dtype
    x, bias = x.float(), bias.float()
    ky, kx, sy, sx = pool
    _, H, W, _ = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    _, r, _, sb = _relu_lrn(x, bias, n, alpha, beta, k)
    p = None
    for win in _pool_windows(r * sb, ky, kx, sy, sx, oh, ow):
        p = win if p is None else torch.maximum(p, win)
    return p.to(dtype)


def fused_block_bwd_plain(x, bias, dp, n=5, alpha=1e-4, beta=0.75, k=2.0,
                          pool=(3, 3, 2, 2)):
    """The plain version of K1b, the reference kernel's backward op by op
    (``pallas_fused_block._bwd_kernel``): the forward recomputed; ``g =
    dp / nt`` split equally among a window's tied maxima and scattered
    back window offset by offset (i outer, j inner); the closed-form LRN
    backward ``dr = dy*sb - (2 alpha beta)*r*W_n(dy*r*(sb/s))``; the
    strict gate ``a > 0``.  Returns ``(dx, db)``: in float32 whatever
    the operands' dtype, as the TPU kernel computes, dx rounded once to
    ``x``'s dtype and db float32."""
    dtype = x.dtype
    x, bias, dp = x.float(), bias.float(), dp.float()
    ky, kx, sy, sx = pool
    _, H, W, _ = x.shape
    oh, ow = dp.shape[1], dp.shape[2]
    a, r, s, sb = _relu_lrn(x, bias, n, alpha, beta, k)
    wins = _pool_windows(r * sb, ky, kx, sy, sx, oh, ow)
    p = None
    for win in wins:
        p = win if p is None else torch.maximum(p, win)
    masks, nt = [], None
    for win in wins:
        mk = (win == p).to(x.dtype)
        masks.append(mk)
        nt = mk if nt is None else nt + mk
    g = dp / nt
    dy = None
    for mi, (i, j) in enumerate((i, j) for i in range(ky)
                                for j in range(kx)):
        part = torch.zeros_like(x)
        part[:, i:i + (oh - 1) * sy + 1:sy,
             j:j + (ow - 1) * sx + 1:sx, :] = g * masks[mi]
        dy = part if dy is None else dy + part
    t = dy * r * (sb / s)
    dr = dy * sb - (2.0 * alpha * beta) * r * windowed_channel_sum(t, n)
    da = dr * (a > 0.0).to(x.dtype)
    return da.to(dtype), torch.sum(da, dim=(0, 1, 2))


def _tiling_pool(x, pool):
    ky, kx, sy, sx = (int(v) for v in pool)
    _, H, W, _ = x.shape
    if (H - ky) % sy or (W - kx) % sx:
        raise ValueError(f"pool {pool} does not tile ({H}, {W}) exactly")
    return ky, kx, sy, sx


#: channel windows K1's float4 path unrolls (``csrc/fused_block.cu``);
#: any other window takes the scalar path
_FWD_VEC_WINDOWS = (1, 3, 5, 7, 9)
#: most input rows K1 keeps in its shared-memory ring
_FWD_MAX_STAGES = 3
#: K1's threads per block
_FWD_THREADS = 512
#: most resident K1 blocks an SM holds: its launch bounds give each of the
#: 512 threads up to 64 registers, so two blocks fill the register file
_FWD_BLOCKS_PER_SM = 2


class FwdPlan(NamedTuple):
    """K1's schedule for one shape: block ``(b, j)`` of the ``B *
    n_strips`` grid owns strip ``j`` of image ``b`` (:func:`_fwd_strip`)."""

    n_strips: int       # strips per image
    stages: int         # input rows in the shared-memory ring
    smem: int           # dynamic shared memory per block, bytes
    vec: bool           # groups of 4 channels and bulk-async rows, else
    #                     scalar channels and 4-byte cp.async
    blocks_per_sm: int  # resident blocks per SM that ``smem`` allows


def _pad128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def _fwd_smem(W, C, OW, ky, sy, stages, esize=4) -> int:
    """K1's shared memory: 128 bytes of mbarriers, ``stages`` input rows
    of ``esize``-byte operands, one normalised float32 row (each padded to
    128 bytes), and ceil(ky/sy) pooled rows of float32 running maxima.
    The kernel lays them out in that order and takes this size as
    given."""
    return (128 + stages * _pad128(W * C * esize) + _pad128(W * C * 4)
            + -(-ky // sy) * OW * C * 4)


def _fwd_strip(oh, n_strips, j, ky, sy):
    """Strip ``j``'s pooled rows ``[oy0, oy1)`` and the input rows ``[r0,
    r1)`` they read, halo included: the kernel's own arithmetic."""
    oy0, oy1 = j * oh // n_strips, (j + 1) * oh // n_strips
    return oy0, oy1, oy0 * sy, (oy1 - 1) * sy + ky


@functools.lru_cache(maxsize=64)
def _fwd_plan(B, H, W, C, pool, smem_limit, n=5, aligned=True,
              n_sms=132, esize=4) -> FwdPlan:
    """K1's schedule for operands of ``esize`` bytes (4 float32, 2 bf16):
    the most ring stages (up to 3) that leave two blocks on an SM, else
    the most that fit one; then the most strips per image whose ``B *
    n_strips`` blocks are all resident at once on ``n_sms`` SMs (at least
    one): no tail wave, and the fewest halo rows read twice.  The group
    path needs the channels in whole 16-byte units (C % 4 == 0 for
    float32, C % 8 == 0 for bf16), 16-byte aligned operands
    (``aligned``) and a window in :data:`_FWD_VEC_WINDOWS`.  Raises
    ``ValueError`` when C > 1024 or one ring stage does not fit
    ``smem_limit``."""
    ky, kx, sy, sx = pool
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if C > 1024:
        raise ValueError(f"fused_block kernel: C {C} > 1024")
    vec = bool(aligned) and C % (16 // esize) == 0 \
        and int(n) in _FWD_VEC_WINDOWS

    def size(stages):
        return _fwd_smem(W, C, ow, ky, sy, stages, esize)

    def per_sm(smem):
        return min(_FWD_BLOCKS_PER_SM,
                   _build.resident_blocks(_FWD_THREADS, smem, smem_limit))

    fitting = [s for s in range(_FWD_MAX_STAGES, 0, -1)
               if size(s) <= smem_limit]
    if not fitting:
        raise ValueError(
            f"fused_block kernel: a ring of {W}x{C} rows of {esize}-byte "
            f"operands needs {size(1)} bytes of shared memory, one block "
            f"may have {smem_limit}")
    stages = next((s for s in fitting if per_sm(size(s)) >= 2), fitting[0])
    occupancy = per_sm(size(stages))
    n_strips = max(1, min(oh, n_sms * occupancy // max(B, 1)))
    longest = (-(-oh // n_strips) - 1) * sy + ky
    stages = min(stages, longest)
    smem = size(stages)
    return FwdPlan(n_strips, stages, smem, vec, per_sm(smem))


def fwd_plan_for(x, bias, n=5, pool=(3, 3, 2, 2)) -> FwdPlan:
    """The :class:`FwdPlan` K1 runs for CUDA tensors ``x``, ``bias``."""
    B, H, W, C = x.shape
    aligned = x.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _fwd_plan(B, H, W, C, _tiling_pool(x, pool), smem_limit, int(n),
                     aligned, n_sms)


def fused_block_fwd(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                    pool=(3, 3, 2, 2)):
    """K1: fused bias+StrictRELU+LRN+maxpool over the RAW conv output
    ``x`` (B, H, W, C).  ``pool`` = (ky, kx, sy, sx) must tile (H, W)
    exactly.  CPU tensors take :func:`fused_block_plain`; CUDA tensors
    launch K1 on :func:`_fwd_plan`'s schedule or raise; bf16 operands
    go to :func:`fused_block_bf16_fwd`."""
    pool = _tiling_pool(x, pool)
    if x.dtype == torch.bfloat16:
        return fused_block_bf16_fwd(x, bias, n, alpha, beta, k, pool)
    if _all_cpu(x, bias):
        return fused_block_plain(x, bias, n, alpha, beta, k, pool)
    _check_kernel_operands("fused_block_fwd", x, bias)
    plan = fwd_plan_for(x, bias, n, pool)
    ky, kx, sy, sx = pool
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    out = torch.empty((B, oh, ow, C), dtype=x.dtype, device=x.device)
    rc = _build.entry("fused_block")(
        x.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, oh, ow,
        int(n), float(alpha), float(beta), float(k), ky, kx, sy, sx,
        int(float(beta) == 0.75), plan.n_strips, plan.stages, plan.smem,
        int(plan.vec), x.device.index, _build.stream_of(x))
    _build.check(rc, "fused_block")
    fused_block_fwd.launches += 1
    return out


#: K1 launches since the count was last reset
fused_block_fwd.launches = 0


@functools.lru_cache(maxsize=64)
def _bf16_fwd_plan(B, H, W, C, pool, smem_limit, n=5, aligned=True,
                   n_sms=132) -> Optional[FwdPlan]:
    """The bf16 K1's schedule: :func:`_fwd_plan` on 2-byte ring rows
    where the group path takes the shape, else ``None``, and the simple
    kernel (one thread a pooled output) runs it: C % 8 != 0, an operand
    not 16-byte aligned, a window outside :data:`_FWD_VEC_WINDOWS`,
    C > 1024, or a ring row that does not fit ``smem_limit``."""
    ky, kx, sy, sx = pool
    _, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if not (aligned and C % 8 == 0 and C <= 1024
            and int(n) in _FWD_VEC_WINDOWS) \
            or _fwd_smem(W, C, ow, ky, sy, 1, 2) > smem_limit:
        return None
    return _fwd_plan(B, H, W, C, pool, smem_limit, n, aligned, n_sms, 2)


def bf16_fwd_plan_for(x, bias, n=5, pool=(3, 3, 2, 2)) -> Optional[FwdPlan]:
    """The :class:`FwdPlan` the bf16 K1 runs for CUDA tensors ``x``,
    ``bias``, or ``None`` for the simple kernel."""
    B, H, W, C = x.shape
    aligned = x.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _bf16_fwd_plan(B, H, W, C, _tiling_pool(x, pool), smem_limit,
                          int(n), aligned, n_sms)


def _bf16_fwd_launch(x, bias, n, alpha, beta, k, pool, plan):
    """Launch the bf16 K1 on ``plan``: the ring kernel, or the simple
    kernel for ``None``."""
    ky, kx, sy, sx = pool
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    out = torch.empty((B, oh, ow, C), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, oh,
            ow, int(n), float(alpha), float(beta), float(k), ky, kx, sy, sx,
            int(float(beta) == 0.75))
    if plan is None:
        fn = "znicz_fused_block_bf16_fwd"
        rc = _build.entry("fused_block", fn)(
            *args, x.device.index, _build.stream_of(x))
    else:
        fn = "znicz_fused_block_bf16_ring_fwd"
        rc = _build.entry("fused_block", fn)(
            *args, plan.n_strips, plan.stages, plan.smem, x.device.index,
            _build.stream_of(x))
    _build.check(rc, "fused_block", fn)
    return out


def fused_block_bf16_fwd(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                         pool=(3, 3, 2, 2)):
    """K1 for bf16 operands (``csrc/fused_block.cu``):
    :func:`fused_block_fwd`'s function computed in float32 and rounded
    once to bf16.  CPU tensors take :func:`fused_block_plain`; CUDA
    tensors launch, on :func:`_bf16_fwd_plan`'s choice, the float32 ring
    kernel on bf16 rows (``znicz_fused_block_bf16_ring_fwd``) or the
    simple kernel (``znicz_fused_block_bf16_fwd``), or raise."""
    pool = _tiling_pool(x, pool)
    if _all_cpu(x, bias):
        return fused_block_plain(x, bias, n, alpha, beta, k, pool)
    _check_kernel_operands("fused_block_bf16_fwd", x, bias,
                           dtype=torch.bfloat16)
    plan = bf16_fwd_plan_for(x, bias, n, pool)
    out = _bf16_fwd_launch(x, bias, n, alpha, beta, k, pool, plan)
    fused_block_bf16_fwd.launches += 1
    fused_block_bf16_fwd.simple_launches += plan is None
    return out


#: bf16 K1 launches since the count was last reset, and those of them that
#: ran the simple kernel
fused_block_bf16_fwd.launches = 0
fused_block_bf16_fwd.simple_launches = 0


#: most resident K1b blocks an SM holds: its launch bounds give each of
#: the 512 threads up to 64 registers, so two blocks fill the register file
_BWD_BLOCKS_PER_SM = 2


class BwdPlan(NamedTuple):
    """K1b's schedule for one shape: block ``(b, j, t)`` of the ``B *
    n_strips * n_ctiles`` grid owns the rectangle of ``dx`` made of strip
    ``j`` of image ``b``'s rows and tile ``t`` of its columns
    (:func:`_bwd_span` along each axis)."""

    n_strips: int       # strips of input rows per image
    n_ctiles: int       # tiles of input columns per strip
    stages: int         # input rows in the shared-memory ring
    smem: int           # dynamic shared memory per block, bytes
    vec: bool           # groups of 4 channels and bulk-async rows, else
    #                     scalar channels and 4-byte cp.async
    blocks_per_sm: int  # resident blocks per SM that ``smem`` allows


class Span(NamedTuple):
    """Part of one axis of a K1b block (rows or columns)."""

    y0: int   # the input rows (columns) whose dx it owns: [y0, y1)
    y1: int
    o0: int   # the pooled rows whose windows reach them: [o0, o1)
    o1: int
    r0: int   # the input rows those windows and the owned rows read:
    r1: int   # [r0, r1), the halo included


def _bwd_span(n_out, n_in, k, s, parts, j) -> Span:
    """Part ``j`` of ``parts`` along one axis of ``n_in`` inputs pooled
    by a window of ``k`` at stride ``s`` into ``n_out``: the parts split
    the ceil(n_in / s) bands of ``s`` inputs evenly, so each owns whole
    bands.  The kernel's own arithmetic."""
    nb = -(-n_in // s)
    m0, m1 = j * nb // parts, (j + 1) * nb // parts
    y0, y1 = m0 * s, min(m1 * s, n_in)
    o0 = max(0, -(-(y0 - k + 1) // s))
    o1 = min(m1, n_out)
    return Span(y0, y1, o0, o1, o0 * s, max(y1, (o1 - 1) * s + k))


def _bwd_gather_row(m, H, oh, ky, sy):
    """The input row after which K1b gathers band ``m`` (input rows [m*sy,
    (m+1)*sy)): the last row of the last pooled row that covers it, or
    its own last row if that comes later."""
    return max(min(m, oh - 1) * sy + ky - 1, min((m + 1) * sy, H) - 1)


def _bwd_hold(ky, sy):
    """Input rows K1b holds for a gather: a band and the rows up to its
    gather row."""
    return max(ky, sy)


def _bwd_pool_slots(ky, sy):
    """Pooled rows K1b keeps at once: those that rows not yet gathered
    need, and the one a new input row starts."""
    return max(1, (2 * ky - 2) // sy)


def _bwd_groups(C, vec):
    """Pixels K1b handles at a time: ``_FWD_THREADS`` threads over one
    pixel's channel groups (float4 or single channels)."""
    return _FWD_THREADS // min(C // 4 if vec else C, _FWD_THREADS)


def _bwd_smem(wt, owt, C, ky, sy, stages, vec, esize=4) -> int:
    """K1b's shared memory for a tile of ``wt`` input and ``owt`` pooled
    columns: 128 bytes of mbarriers, ``stages`` input rows of
    ``esize``-byte operands and one normalised float32 row, the float32
    running maxima and then ``g`` of :func:`_bwd_pool_slots` pooled rows
    (each, and each array, padded to 128 bytes), and one row of C floats
    per pixel in flight for the LRN backward's window.  The kernel lays
    them out in that order and takes this size as given."""
    return (128 + stages * _pad128(wt * C * esize) + _pad128(wt * C * 4)
            + 2 * _pad128(_bwd_pool_slots(ky, sy) * owt * C * 4)
            + _pad128(_bwd_groups(C, vec) * C * 4))


@functools.lru_cache(maxsize=64)
def _bwd_plan(B, H, W, C, pool, smem_limit, n=5, aligned=True,
              n_sms=132, esize=4) -> BwdPlan:
    """K1b's schedule for operands of ``esize`` bytes (4 float32, 2
    bf16): the fewest column tiles, and then the most ring stages (two or
    one beyond the rows a gather holds), that keep two blocks on an SM
    while every block is resident at once; else one block an SM, in one
    wave if the layout fits; else the fewest tiles that fit one block.
    Then as many strips per image as keep the grid in one wave (at least
    one).  The group path needs the channels in whole 16-byte units (C %
    4 == 0 for float32, C % 8 == 0 for bf16), 16-byte aligned operands
    and a window in :data:`_FWD_VEC_WINDOWS`.  Raises ``ValueError`` when
    C > 1024 or no layout fits ``smem_limit``."""
    ky, kx, sy, sx = pool
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if C > 1024:
        raise ValueError(f"fused_block_bwd kernel: C {C} > 1024")
    vec = bool(aligned) and C % (16 // esize) == 0 \
        and int(n) in _FWD_VEC_WINDOWS
    hold = _bwd_hold(ky, sy)
    nbx = -(-W // sx)

    def per_sm(smem):
        return min(_BWD_BLOCKS_PER_SM,
                   (smem_limit + _build.SMEM_RESERVED)
                   // (smem + _build.SMEM_RESERVED))

    def layout(n_ctiles, stages):
        tiles = [_bwd_span(ow, W, kx, sx, n_ctiles, t)
                 for t in range(n_ctiles)]
        return _bwd_smem(max(t.r1 - t.r0 for t in tiles),
                         max(t.o1 - t.o0 for t in tiles), C, ky, sy,
                         stages, vec, esize)

    choice = None
    for occupancy, one_wave in ((2, True), (1, True), (1, False)):
        for n_ctiles in range(1, nbx + 1):
            if one_wave and n_ctiles > 1 \
                    and B * n_ctiles > n_sms * occupancy:
                break
            sizes = [(s, layout(n_ctiles, s)) for s in (hold + 2, hold + 1)]
            found = next(((s, smem) for s, smem in sizes
                          if per_sm(smem) >= occupancy), None)
            if found is not None:
                choice = (n_ctiles, *found)
                break
        if choice is not None:
            break
    if choice is None:
        raise ValueError(
            f"fused_block_bwd kernel: a ring of {hold + 1} rows of {W}x{C} "
            f"{esize}-byte operands needs {layout(nbx, hold + 1)} bytes of "
            f"shared memory in its narrowest tiles, one block may have "
            f"{smem_limit}")
    n_ctiles, stages, smem = choice
    slots = n_sms * per_sm(smem)
    n_strips = max(1, min(-(-H // sy), slots // max(B * n_ctiles, 1)))
    return BwdPlan(n_strips, n_ctiles, stages, smem, vec, per_sm(smem))


def bwd_plan_for(x, bias, n=5, pool=(3, 3, 2, 2), dp=None) -> BwdPlan:
    """The :class:`BwdPlan` K1b runs for CUDA tensors ``x``, ``bias`` (and
    the cotangent ``dp``, whose alignment counts too)."""
    B, H, W, C = x.shape
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x, bias, dp) if t is not None)
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _bwd_plan(B, H, W, C, _tiling_pool(x, pool), smem_limit, int(n),
                     aligned, n_sms)


def fused_block_bwd(x, bias, dp, n=5, alpha=1e-4, beta=0.75, k=2.0,
                    pool=(3, 3, 2, 2)):
    """K1b: ``(dx, db)`` of :func:`fused_block_fwd` for the pooled
    cotangent ``dp``, recomputing the forward from ``(x, bias)``.  CPU
    tensors take :func:`fused_block_bwd_plain`; CUDA tensors launch K1b
    on :func:`_bwd_plan`'s schedule or raise; bf16 operands go to
    :func:`fused_block_bf16_bwd`.  db comes back in the bias's dtype."""
    ky, kx, sy, sx = _tiling_pool(x, pool)
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if tuple(dp.shape) != (B, oh, ow, C):
        raise ValueError(f"fused_block_bwd: dp {tuple(dp.shape)}, expected "
                         f"{(B, oh, ow, C)}")
    if x.dtype == torch.bfloat16:
        dx, db = fused_block_bf16_bwd(x, bias, dp, n, alpha, beta, k,
                                      (ky, kx, sy, sx))
        return dx, db.to(bias.dtype)
    if _all_cpu(x, bias, dp):
        dx, db = fused_block_bwd_plain(x, bias, dp, n, alpha, beta, k,
                                       (ky, kx, sy, sx))
        return dx, db.to(bias.dtype)
    _check_kernel_operands("fused_block_bwd", x, bias, dp)
    plan = bwd_plan_for(x, bias, n, (ky, kx, sy, sx), dp)
    dx = torch.empty_like(x)
    db = torch.empty((C,), dtype=x.dtype, device=x.device)
    partial = torch.empty((max(B * plan.n_strips * plan.n_ctiles, 1), C),
                          dtype=x.dtype, device=x.device)
    rc = _build.entry("fused_block_bwd")(
        x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
        db.data_ptr(), partial.data_ptr(), B, H, W, C, oh, ow, int(n),
        float(alpha), float(beta), float(k), float(2.0 * alpha * beta),
        ky, kx, sy, sx, int(float(beta) == 0.75), plan.n_strips,
        plan.n_ctiles, plan.stages, plan.smem, int(plan.vec),
        x.device.index, _build.stream_of(x))
    _build.check(rc, "fused_block_bwd")
    fused_block_bwd.launches += 1
    return dx, db


#: K1b launches since the count was last reset
fused_block_bwd.launches = 0

#: threads a simple bf16 K2b or K1b block has (``kBf16Threads`` in
#: ``csrc/fused_block_bwd.cu`` and ``csrc/bias_relu_bwd.cu``), the blocks
#: their planners give each SM, and the channels a simple bf16 K1b thread
#: takes
_BF16_THREADS, _BF16_BLOCKS_PER_SM, _BF16_GROUPS = 256, 8, 4


def _bf16_channel_threads(C: int) -> int:
    """Threads over ``C`` channels, in whole warps, at most a block."""
    return min(-(-C // 32) * 32, _BF16_THREADS)


@functools.lru_cache(maxsize=64)
def _bf16_simple_bwd_plan(pixels: int, C: int,
                          n_sms: int = 132) -> Tuple[int, int]:
    """The simple bf16 K1b's launch, a function of the shape alone so
    that db sums in one order on every run: ``(tpc, blocks)``, ``tpc``
    threads a pixel over its channels (each thread at most four channels)
    and ``blocks`` blocks over the ``pixels`` NHWC pixels.  Raises
    ``ValueError`` when C > 1024."""
    tpc = _bf16_channel_threads(C)
    if tpc * _BF16_GROUPS < C:
        raise ValueError(f"fused_block_bf16_bwd kernel: C {C} > "
                         f"{_BF16_THREADS * _BF16_GROUPS}")
    slots = _BF16_THREADS // tpc
    return tpc, max(1, min(-(-pixels // slots), n_sms * _BF16_BLOCKS_PER_SM))


@functools.lru_cache(maxsize=64)
def _bf16_bwd_plan(B, H, W, C, pool, smem_limit, n=5, aligned=True,
                        n_sms=132) -> Optional[BwdPlan]:
    """The bf16 K1b's schedule: :func:`_bwd_plan` on 2-byte ring rows
    where the group path takes the shape, else ``None``, and the simple
    kernels run it: C % 8 != 0, an operand not 16-byte aligned, a window
    outside :data:`_FWD_VEC_WINDOWS`, C > 1024, or a layout that does not
    fit ``smem_limit`` in the narrowest tiles."""
    ky, kx, sy, sx = pool
    _, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if not (aligned and C % 8 == 0 and C <= 1024
            and int(n) in _FWD_VEC_WINDOWS):
        return None
    nbx = -(-W // sx)
    tiles = [_bwd_span(ow, W, kx, sx, nbx, t) for t in range(nbx)]
    if _bwd_smem(max(t.r1 - t.r0 for t in tiles),
                 max(t.o1 - t.o0 for t in tiles), C, ky, sy,
                 _bwd_hold(ky, sy) + 1, True, 2) > smem_limit:
        return None
    return _bwd_plan(B, H, W, C, pool, smem_limit, n, aligned, n_sms, 2)


def bf16_bwd_plan_for(x, bias, n=5, pool=(3, 3, 2, 2),
                      dp=None) -> Optional[BwdPlan]:
    """The :class:`BwdPlan` the bf16 K1b runs for CUDA tensors ``x``,
    ``bias`` (and ``dp``, whose alignment counts too), or ``None`` for the
    simple kernels."""
    B, H, W, C = x.shape
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x, bias, dp) if t is not None)
    smem_limit, n_sms = _build.device_limits(x.device.index)
    return _bf16_bwd_plan(B, H, W, C, _tiling_pool(x, pool), smem_limit,
                               int(n), aligned, n_sms)


def _bf16_bwd_launch(x, bias, dp, n, alpha, beta, k, pool, plan):
    """Launch the bf16 K1b on ``plan``: the ring kernel and the column
    sum, or for ``None`` the simple kernels (a pool pass into float32
    scratch ``pm``/``pg``, a gather pass, the column sum)."""
    ky, kx, sy, sx = pool
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x)
    db = torch.empty((C,), **f32)
    hyper = (B, H, W, C, oh, ow, int(n), float(alpha), float(beta), float(k),
             float(2.0 * alpha * beta), ky, kx, sy, sx,
             int(float(beta) == 0.75))
    if plan is None:
        tpc, blocks = _bf16_simple_bwd_plan(B * H * W, C,
                                     _build.device_limits(x.device.index)[1])
        pm = torch.empty(tuple(dp.shape), **f32)
        pg = torch.empty(tuple(dp.shape), **f32)
        partial = torch.empty((blocks, C), **f32)
        fn = "znicz_fused_block_bf16_bwd"
        rc = _build.entry("fused_block_bwd", fn)(
            x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
            db.data_ptr(), pm.data_ptr(), pg.data_ptr(), partial.data_ptr(),
            *hyper, tpc, blocks, x.device.index, _build.stream_of(x))
    else:
        partial = torch.empty((max(B * plan.n_strips * plan.n_ctiles, 1), C),
                              **f32)
        fn = "znicz_fused_block_bf16_ring_bwd"
        rc = _build.entry("fused_block_bwd", fn)(
            x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
            db.data_ptr(), partial.data_ptr(), *hyper, plan.n_strips,
            plan.n_ctiles, plan.stages, plan.smem, x.device.index,
            _build.stream_of(x))
    _build.check(rc, "fused_block_bwd", fn)
    return dx, db


def fused_block_bf16_bwd(x, bias, dp, n=5, alpha=1e-4, beta=0.75, k=2.0,
                         pool=(3, 3, 2, 2)):
    """K1b for bf16 operands (``csrc/fused_block_bwd.cu``): ``(dx, db)``
    of :func:`fused_block_bwd` computed in float32, dx rounded once to
    bf16 and db float32, as the TPU kernel writes it
    (:func:`fused_block_bwd` casts it to the bias's dtype).  CPU tensors
    take :func:`fused_block_bwd_plain`; CUDA tensors launch, on
    :func:`_bf16_bwd_plan`'s choice, the float32 ring kernel on bf16
    rows (``znicz_fused_block_bf16_ring_bwd``) or the simple kernels
    (``znicz_fused_block_bf16_bwd``), or raise."""
    ky, kx, sy, sx = _tiling_pool(x, pool)
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if tuple(dp.shape) != (B, oh, ow, C):
        raise ValueError(f"fused_block_bf16_bwd: dp {tuple(dp.shape)}, "
                         f"expected {(B, oh, ow, C)}")
    if _all_cpu(x, bias, dp):
        return fused_block_bwd_plain(x, bias, dp, n, alpha, beta, k,
                                     (ky, kx, sy, sx))
    _check_kernel_operands("fused_block_bf16_bwd", x, bias, dp,
                           dtype=torch.bfloat16)
    pool = (ky, kx, sy, sx)
    plan = bf16_bwd_plan_for(x, bias, n, pool, dp)
    dx, db = _bf16_bwd_launch(x, bias, dp, n, alpha, beta, k, pool, plan)
    fused_block_bf16_bwd.launches += 1
    fused_block_bf16_bwd.simple_launches += plan is None
    return dx, db


#: bf16 K1b launches since the count was last reset, and those of them
#: that ran the simple kernels
fused_block_bf16_bwd.launches = 0
fused_block_bf16_bwd.simple_launches = 0


class _FusedBlock(torch.autograd.Function):
    """The reference's custom vjp (``pallas_fused_block.py:256-273``):
    the residual is ``(x, bias)`` only."""

    @staticmethod
    def forward(ctx, x, bias, n, alpha, beta, k, pool):
        ctx.save_for_backward(x, bias)
        ctx.hypers = (n, alpha, beta, k, pool)
        return fused_block_fwd(x, bias, n, alpha, beta, k, pool)

    @staticmethod
    def backward(ctx, dp):
        x, bias = ctx.saved_tensors
        dx, db = fused_block_bwd(x, bias, dp.contiguous(), *ctx.hypers)
        return dx, db, None, None, None, None, None


def fused_block(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                pool=(3, 3, 2, 2)):
    """Fused bias+StrictRELU+LRN+maxpool over the RAW conv output ``x``
    (B, H, W, C), with K1 forward and K1b backward."""
    return _FusedBlock.apply(x, bias, int(n), float(alpha), float(beta),
                             float(k), _tiling_pool(x, pool))


# -- K2 / K2b: bias + ReLU -----------------------------------------------------


def bias_relu_plain(x, bias):
    """The plain version of K2: ``relu(x + b)``, in float32 whatever the
    operands' dtype and rounded once to ``x``'s dtype."""
    return torch.clamp_min(x.float() + bias.float(), 0.0).to(x.dtype)


def bias_relu_bwd_plain(x, bias, dp):
    """The plain version of K2b: ``dx = dp * [x + b > 0]`` and ``db``,
    the sum of ``dx`` over every leading axis, in float32 whatever the
    operands' dtype.  Returns ``(dx, db)``: dx rounded once to ``x``'s
    dtype, db float32."""
    da = dp.float() * ((x.float() + bias.float()) > 0.0).to(torch.float32)
    return da.to(x.dtype), torch.sum(da, dim=tuple(range(da.ndim - 1)))


def bias_relu_fwd(x, bias):
    """K2: fused bias+StrictRELU over a (B, H, W, C) conv output.  CPU
    tensors take :func:`bias_relu_plain`; bf16 operands go to
    :func:`bias_relu_bf16_fwd`."""
    if x.ndim != 4:
        raise ValueError(f"fused_bias_relu expects NHWC, got {x.shape}")
    if x.dtype == torch.bfloat16:
        return bias_relu_bf16_fwd(x, bias)
    if _all_cpu(x, bias):
        return bias_relu_plain(x, bias)
    _check_kernel_operands("bias_relu_fwd", x, bias)
    y = torch.empty_like(x)
    rc = _build.entry("bias_relu")(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(),
        int(x.shape[-1]), x.device.index, _build.stream_of(x))
    _build.check(rc, "bias_relu")
    bias_relu_fwd.launches += 1
    return y


#: K2 launches since the count was last reset
bias_relu_fwd.launches = 0


def _aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _bf16_relu_fwd_route(C: int, aligned: bool) -> str:
    """The bf16 K2's kernel for ``C`` channels: ``"bf16x8"``, the float32
    K2's design on 16-byte units of eight bf16
    (``znicz_bias_relu_bf16_vec_fwd``), where C % 8 == 0 and x and b are
    16-byte aligned (``aligned``; y is the wrapper's own), else
    ``"simple"``, the kernel of one element a thread
    (``znicz_bias_relu_bf16_fwd``)."""
    return "bf16x8" if aligned and C % 8 == 0 else "simple"


def _bf16_relu_fwd_launch(x, bias, route):
    """Launch the bf16 K2 on ``route`` (:func:`_bf16_relu_fwd_route`)."""
    y = torch.empty_like(x)
    fn = ("znicz_bias_relu_bf16_vec_fwd" if route == "bf16x8"
          else "znicz_bias_relu_bf16_fwd")
    rc = _build.entry("bias_relu", fn)(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(),
        int(x.shape[-1]), x.device.index, _build.stream_of(x))
    _build.check(rc, "bias_relu", fn)
    return y


def bias_relu_bf16_fwd(x, bias):
    """K2 for bf16 operands (``csrc/bias_relu.cu``): ``relu(x + b)`` in
    float32, rounded once to bf16.  CPU tensors take
    :func:`bias_relu_plain`; CUDA tensors launch the kernel
    :func:`_bf16_relu_fwd_route` names, or raise."""
    if x.ndim != 4:
        raise ValueError(f"fused_bias_relu expects NHWC, got {x.shape}")
    if _all_cpu(x, bias):
        return bias_relu_plain(x, bias)
    _check_kernel_operands("bias_relu_bf16_fwd", x, bias,
                           dtype=torch.bfloat16)
    route = _bf16_relu_fwd_route(int(x.shape[-1]), _aligned16(x, bias))
    y = _bf16_relu_fwd_launch(x, bias, route)
    bias_relu_bf16_fwd.launches += 1
    bias_relu_bf16_fwd.simple_launches += route == "simple"
    return y


#: bf16 K2 launches since the count was last reset, and those of them that
#: ran the simple kernel
bias_relu_bf16_fwd.launches = 0
bias_relu_bf16_fwd.simple_launches = 0


#: most threads a K2b block has (``kMaxThreads`` in
#: ``csrc/bias_relu_bwd.cu``) and the blocks it plans for each SM
_BR_THREADS, _BR_BLOCKS_PER_SM = 512, 2


class BiasReluBwdPlan(NamedTuple):
    """K2b's launch for one shape: block ``(i, j)`` of the ``row_blocks x
    chunks`` grid walks rows :func:`_br_rows` ``(i)`` of channel chunk
    ``j``, ``rows`` of them in flight, ``threads_per_row`` threads a row."""

    vec: bool              # units of `width` channels, 16-byte accesses
    threads_per_row: int   # units of one channel chunk
    rows: int              # pixel rows in flight in a block
    chunks: int            # channel chunks
    row_blocks: int        # blocks along the rows: partial rows of db
    splits: int            # threads a unit that add the partial rows
    smem: int              # dynamic shared memory per block, bytes
    width: int             # channels a unit: 4 float32 or 8 bf16, else 1


def _br_rows(rows, row_blocks, i):
    """Rows ``[r0, r1)`` that K2b's block row ``i`` sums: the kernel's own
    arithmetic."""
    return i * rows // row_blocks, (i + 1) * rows // row_blocks


@functools.lru_cache(maxsize=64)
def _bias_relu_bwd_plan(rows, C, aligned=True, n_sms=132,
                        width=4) -> BiasReluBwdPlan:
    """K2b's launch, a function of the shape alone, so db sums in one order
    on every run: a unit of ``width`` channels (four float32 or eight bf16:
    C % width == 0 and 16-byte aligned operands, ``aligned``) or of one;
    as few channel chunks of at most 512 units as cover C, split evenly;
    as many rows in flight as fill 512 threads; two blocks an SM in all,
    each an equal run of rows; and as many threads a unit for the final
    sum as the block has."""
    vec = bool(aligned) and C % width == 0
    w = width if vec else 1
    units = C // w
    chunks = -(-units // _BR_THREADS)
    tpr = -(-units // chunks)
    r = max(1, _BR_THREADS // tpr)
    row_blocks = max(1, min(-(-rows // r),
                            n_sms * _BR_BLOCKS_PER_SM // chunks))
    splits = max(1, min(tpr * r // units, row_blocks))
    return BiasReluBwdPlan(vec, tpr, r, chunks, row_blocks, splits,
                           tpr * r * w * 4, w)


#: (device, stream) -> (partial rows, ticket) of K2b's launches there: the
#: ticket is zeroed once and every launch leaves it zero
_BR_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _br_workspace(device, stream: int, floats: int):
    key = (device.index, stream)
    ws = _BR_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < floats:
        ticket = ws[1] if ws is not None else \
            torch.zeros((1,), dtype=torch.int32, device=device)
        ws = _BR_WORKSPACE[key] = (
            torch.empty((floats,), dtype=torch.float32, device=device),
            ticket)
    return ws


def bias_relu_bwd_plan_for(x, bias, dp) -> BiasReluBwdPlan:
    """The :class:`BiasReluBwdPlan` K2b runs for CUDA tensors ``x``,
    ``bias``, ``dp``."""
    C = int(x.shape[-1])
    return _bias_relu_bwd_plan(x.numel() // C, C, _aligned16(x, bias, dp),
                               _build.device_limits(x.device.index)[1])


def bias_relu_bwd(x, bias, dp):
    """K2b: ``(dx, db)`` of :func:`bias_relu_fwd` for the cotangent
    ``dp``, the gate recomputed from ``(x, bias)``.  CPU tensors take
    :func:`bias_relu_bwd_plain`; CUDA tensors launch K2b on
    :func:`_bias_relu_bwd_plan`'s launch or raise; bf16 operands go to
    :func:`bias_relu_bf16_bwd`.  db comes back in the bias's dtype."""
    if x.ndim != 4 or dp.shape != x.shape:
        raise ValueError(f"bias_relu_bwd: x {tuple(x.shape)} and dp "
                         f"{tuple(dp.shape)} must be the same NHWC shape")
    if x.dtype == torch.bfloat16:
        dx, db = bias_relu_bf16_bwd(x, bias, dp)
        return dx, db.to(bias.dtype)
    if _all_cpu(x, bias, dp):
        dx, db = bias_relu_bwd_plain(x, bias, dp)
        return dx, db.to(bias.dtype)
    _check_kernel_operands("bias_relu_bwd", x, bias, dp)
    C = int(x.shape[-1])
    p = bias_relu_bwd_plan_for(x, bias, dp)
    stream = _build.stream_of(x)
    partial, ticket = _br_workspace(x.device, stream, p.row_blocks * C)
    dx = torch.empty_like(x)
    db = torch.empty((C,), dtype=x.dtype, device=x.device)
    rc = _build.entry("bias_relu_bwd")(
        x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
        db.data_ptr(), partial.data_ptr(), ticket.data_ptr(), x.numel() // C,
        C, int(p.vec), p.threads_per_row, p.rows, p.chunks, p.row_blocks,
        p.splits, x.device.index, stream)
    _build.check(rc, "bias_relu_bwd")
    bias_relu_bwd.launches += 1
    return dx, db


#: K2b launches since the count was last reset
bias_relu_bwd.launches = 0


@functools.lru_cache(maxsize=64)
def _bf16_simple_relu_plan(rows: int, C: int,
                           n_sms: int = 132) -> Tuple[int, int, int]:
    """The simple bf16 K2b's launch, a function of the shape alone so that
    db sums in one order on every run: ``(tpc, chunks, row_blocks)``, as
    few chunks of at most a block's threads as cover C, split evenly,
    ``tpc`` threads a row of a chunk, and ``row_blocks`` blocks along the
    rows."""
    chunks = -(-C // _BF16_THREADS)
    tpc = _bf16_channel_threads(-(-C // chunks))
    slots = _BF16_THREADS // tpc
    return tpc, chunks, max(1, min(-(-rows // slots),
                                   n_sms * _BF16_BLOCKS_PER_SM // chunks))


@functools.lru_cache(maxsize=64)
def _bf16_relu_bwd_plan(rows: int, C: int, aligned: bool = True,
                        n_sms: int = 132) -> Optional[BiasReluBwdPlan]:
    """The bf16 K2b's launch: the float32 K2b's plan
    (:func:`_bias_relu_bwd_plan`) on 16-byte units of eight bf16 channels
    (``znicz_bias_relu_bf16_vec_bwd``) where C % 8 == 0 and x, b and dp are
    16-byte aligned (``aligned``; dx, db and the partial rows are the
    wrapper's own), else ``None``: the simple kernel and the column sum
    (``znicz_bias_relu_bf16_bwd``, :func:`_bf16_simple_relu_plan`)."""
    if not aligned or C % 8:
        return None
    return _bias_relu_bwd_plan(rows, C, True, n_sms, 8)


def bf16_relu_bwd_plan_for(x, bias, dp) -> Optional[BiasReluBwdPlan]:
    """The plan the bf16 K2b runs for CUDA tensors ``x``, ``bias``, ``dp``
    (:func:`_bf16_relu_bwd_plan`; ``None`` for the simple kernel)."""
    C = int(x.shape[-1])
    return _bf16_relu_bwd_plan(x.numel() // C, C, _aligned16(x, bias, dp),
                               _build.device_limits(x.device.index)[1])


def _bf16_relu_bwd_launch(x, bias, dp, plan):
    """Launch the bf16 K2b on ``plan``: the 16-byte kernel, or the simple
    kernel and the column sum for ``None``.  Both take their partial rows
    from :func:`_br_workspace`."""
    C = int(x.shape[-1])
    rows = x.numel() // C
    stream = _build.stream_of(x)
    dx = torch.empty_like(x)
    db = torch.empty((C,), dtype=torch.float32, device=x.device)
    if plan is None:
        tpc, chunks, row_blocks = _bf16_simple_relu_plan(
            rows, C, _build.device_limits(x.device.index)[1])
        partial, _ = _br_workspace(x.device, stream, row_blocks * C)
        fn = "znicz_bias_relu_bf16_bwd"
        rc = _build.entry("bias_relu_bwd", fn)(
            x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
            db.data_ptr(), partial.data_ptr(), rows, C, tpc, chunks,
            row_blocks, x.device.index, stream)
    else:
        partial, ticket = _br_workspace(x.device, stream,
                                        plan.row_blocks * C)
        fn = "znicz_bias_relu_bf16_vec_bwd"
        rc = _build.entry("bias_relu_bwd", fn)(
            x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
            db.data_ptr(), partial.data_ptr(), ticket.data_ptr(), rows, C,
            plan.threads_per_row, plan.rows, plan.chunks, plan.row_blocks,
            plan.splits, x.device.index, stream)
    _build.check(rc, "bias_relu_bwd", fn)
    return dx, db


def bias_relu_bf16_bwd(x, bias, dp):
    """K2b for bf16 operands (``csrc/bias_relu_bwd.cu``): ``(dx, db)`` of
    :func:`bias_relu_bwd` in float32, dx rounded once to bf16 and db
    float32 (:func:`bias_relu_bwd` casts it to the bias's dtype).  CPU
    tensors take :func:`bias_relu_bwd_plain`; CUDA tensors launch the
    kernel :func:`_bf16_relu_bwd_plan` chooses, or raise."""
    if x.ndim != 4 or dp.shape != x.shape:
        raise ValueError(f"bias_relu_bf16_bwd: x {tuple(x.shape)} and dp "
                         f"{tuple(dp.shape)} must be the same NHWC shape")
    if _all_cpu(x, bias, dp):
        return bias_relu_bwd_plain(x, bias, dp)
    _check_kernel_operands("bias_relu_bf16_bwd", x, bias, dp,
                           dtype=torch.bfloat16)
    plan = bf16_relu_bwd_plan_for(x, bias, dp)
    dx, db = _bf16_relu_bwd_launch(x, bias, dp, plan)
    bias_relu_bf16_bwd.launches += 1
    bias_relu_bf16_bwd.simple_launches += plan is None
    return dx, db


#: bf16 K2b launches since the count was last reset, and those of them
#: that ran the simple kernel
bias_relu_bf16_bwd.launches = 0
bias_relu_bf16_bwd.simple_launches = 0


class _BiasRelu(torch.autograd.Function):
    """The reference's custom vjp (``pallas_fused_block.py:456-473``):
    the residual is ``(x, bias)`` only."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_relu_fwd(x, bias)

    @staticmethod
    def backward(ctx, dp):
        x, bias = ctx.saved_tensors
        return bias_relu_bwd(x, bias, dp.contiguous())


def fused_bias_relu(x, bias):
    """Fused bias+StrictRELU over a (B, H, W, C) conv output — the
    conv3-5 stage — with K2 forward and K2b backward."""
    return _BiasRelu.apply(x, bias)


# -- the FC epilogue and the loss head (plain PyTorch) -------------------------


class _FcEpilogue(torch.autograd.Function):
    """``relu(y + b)`` times an optional dropout mask.  The residual is
    ``(y, bias)``; the backward recomputes the gate and calls
    ``mask_of`` again for the mask (``pallas_fused_block.py:493-534``).
    The reference's dtypes: a bf16 ``y`` times the float32 mask is
    float32; the gradients come back in ``y``'s and ``bias``'s dtypes."""

    @staticmethod
    def forward(ctx, y, bias, mask_of):
        ctx.save_for_backward(y, bias)
        ctx.mask_of = mask_of
        r = torch.clamp_min(y + bias, 0.0)
        return r * mask_of() if mask_of is not None else r

    @staticmethod
    def backward(ctx, g):
        y, bias = ctx.saved_tensors
        da = g * ((y + bias) > 0.0).to(g.dtype)
        if ctx.mask_of is not None:
            da = da * ctx.mask_of().to(g.dtype)
        return (da.to(y.dtype),
                torch.sum(da, dim=tuple(range(da.ndim - 1))).to(bias.dtype),
                None)


def fused_fc_epilogue(y, bias, mask_of: Optional[Callable] = None):
    """The FC epilogue over the raw product ``y``: bias + StrictRELU, and
    in training the inverted-dropout mask ``mask_of()`` — a function that
    returns the same mask each time it is called, so the backward
    regenerates it instead of keeping it."""
    return _FcEpilogue.apply(y, bias, mask_of)


class _SoftmaxXent(torch.autograd.Function):
    """Softmax-CE loss with the reference's custom vjp
    (``pallas_fused_block.py:537-568``): the backward re-reads the logits
    and writes ``(softmax - onehot) * valid / denom * g``."""

    @staticmethod
    def forward(ctx, logits, labels, valid, denom):
        ctx.save_for_backward(logits, labels, valid)
        ctx.denom = denom
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, 1, labels[:, None])[:, 0]
        return torch.sum(torch.where(valid, logz - ll, 0.0)) / denom

    @staticmethod
    def backward(ctx, g):
        lg, labels, valid = ctx.saved_tensors
        p = torch.softmax(lg, dim=-1)
        onehot = torch.nn.functional.one_hot(labels, lg.shape[-1]) \
            .to(lg.dtype)
        d = (p - onehot) * valid[:, None].to(lg.dtype) / ctx.denom * g
        return d, None, None, None


def fused_softmax_xent(logits, labels, valid, denom: float):
    """Mean softmax-CE of the valid rows: ``sum(valid * (logsumexp -
    logit[label])) / denom``.  ``labels`` are int64, ``valid`` a bool
    row mask."""
    return _SoftmaxXent.apply(logits, labels, valid, float(denom))


# -- planners ------------------------------------------------------------------


def match_fused_block(forwards: Sequence, i: int) -> Optional[FusedBlockSpec]:
    """The FusedBlockSpec for a conv block starting at ``forwards[i]``, or
    None: ConvStrictRELU(+bias) -> LRN (odd window) -> exactly tiling
    MaxPooling (span 3), or a plain Conv(+bias) -> standalone StrictRELU
    activation -> LRN -> MaxPooling (span 4)."""
    from znicz_torch.activation import is_strict_relu_unit
    from znicz_torch.conv import Conv
    from znicz_torch.lrn import LRNormalizerForward
    from znicz_torch.ops import activations
    from znicz_torch.pooling import MaxPooling

    conv = forwards[i]
    if not isinstance(conv, Conv) or not conv.include_bias:
        return None
    j = i + 1
    if conv.ACTIVATION is activations.strict_relu:
        pass
    elif conv.ACTIVATION is activations.identity and j < len(forwards) \
            and is_strict_relu_unit(forwards[j]):
        j += 1
    else:
        return None
    if j + 1 >= len(forwards):
        return None
    lrn_u, pool_u = forwards[j], forwards[j + 1]
    if not isinstance(lrn_u, LRNormalizerForward):
        return None
    hypers = lrn_u.fused_block_hypers
    if hypers is None:
        return None
    # exactly this class: max-abs, stochastic and average pools differ
    if type(pool_u) is not MaxPooling or not pool_u.exact_tiling():
        return None
    n, alpha, beta, k = hypers
    sy, sx = pool_u.sliding
    return FusedBlockSpec(span=j + 2 - i, n=n, alpha=alpha, beta=beta, k=k,
                          pool=(pool_u.ky, pool_u.kx, sy, sx))


def plan_fused_blocks(forwards: Sequence) -> Dict[int, FusedBlockSpec]:
    """start index -> FusedBlockSpec for every fusable conv block, or {}
    when ``fused_elementwise`` is off or an LRN-formulation knob is on."""
    eng = root.common.engine
    if not bool(eng.get("fused_elementwise", False)):
        return {}
    if any(bool(eng.get(knob, False))
           for knob in ("lrn_pow", "lrn_autodiff", "pallas_lrn")):
        return {}
    plan: Dict[int, FusedBlockSpec] = {}
    i = 0
    while i < len(forwards):
        spec = match_fused_block(forwards, i)
        if spec is not None:
            plan[i] = spec
            i += spec.span
        else:
            i += 1
    return plan


def match_conv_bias_relu(forwards: Sequence, i: int) \
        -> Optional[FusedTailSpec]:
    """Conv(+bias) with a StrictRELU, in its class (span 1) or as a
    standalone activation after a plain Conv (span 2), with no LRN/pool
    requirement: conv3-5."""
    from znicz_torch.activation import is_strict_relu_unit
    from znicz_torch.conv import Conv
    from znicz_torch.ops import activations

    conv = forwards[i]
    if not isinstance(conv, Conv) or not conv.include_bias:
        return None
    if conv.ACTIVATION is activations.strict_relu:
        return FusedTailSpec("conv_bias_relu", 1)
    if conv.ACTIVATION is activations.identity and i + 1 < len(forwards) \
            and is_strict_relu_unit(forwards[i + 1]):
        return FusedTailSpec("conv_bias_relu", 2)
    return None


def match_fc_epilogue(forwards: Sequence, i: int) -> Optional[FusedTailSpec]:
    """All2AllStrictRELU(+bias), absorbing a following DropoutForward
    (span 2): fc6/fc7.  The softmax head is not matched."""
    from znicz_torch.all2all import All2All, All2AllSoftmax
    from znicz_torch.dropout import DropoutForward
    from znicz_torch.ops import activations

    f = forwards[i]
    if not isinstance(f, All2All) or isinstance(f, All2AllSoftmax):
        return None
    if type(f).ACTIVATION is not activations.strict_relu \
            or not f.include_bias:
        return None
    if i + 1 < len(forwards) and isinstance(forwards[i + 1],
                                            DropoutForward):
        return FusedTailSpec("fc_epilogue", 2,
                             float(forwards[i + 1].dropout_ratio), i + 1)
    return FusedTailSpec("fc_epilogue", 1)


def match_seq_epilogue(forwards: Sequence, i: int) \
        -> Optional[FusedTailSpec]:
    """SeqAll2AllStrictRELU(+bias), the position-wise FFN (span 1): the
    raw per-token product, then the FC epilogue with no dropout.  The
    softmax head is not matched."""
    from znicz_torch.attention import SeqAll2All, SeqAll2AllSoftmax
    from znicz_torch.ops import activations

    f = forwards[i]
    if not isinstance(f, SeqAll2All) or isinstance(f, SeqAll2AllSoftmax):
        return None
    if type(f).ACTIVATION is not activations.strict_relu \
            or not f.include_bias:
        return None
    return FusedTailSpec("seq_epilogue", 1)


def plan_fused_tail(forwards: Sequence,
                    block_plan: Optional[Dict[int, FusedBlockSpec]] = None
                    ) -> Dict[int, FusedTailSpec]:
    """start index -> FusedTailSpec for every fusable tail stage, or {}
    when ``fused_tail`` is off.  Indices inside a conv-block span are
    skipped: the block kernel owns their bias+ReLU."""
    if not bool(root.common.engine.get("fused_tail", False)):
        return {}
    covered = set()
    for i, spec in (block_plan or {}).items():
        covered.update(range(i, i + spec.span))
    plan: Dict[int, FusedTailSpec] = {}
    i = 0
    while i < len(forwards):
        if i in covered:
            i += 1
            continue
        spec = match_conv_bias_relu(forwards, i) \
            or match_fc_epilogue(forwards, i) \
            or match_seq_epilogue(forwards, i)
        if spec is not None:
            plan[i] = spec
            i += spec.span
        else:
            i += 1
    return plan
