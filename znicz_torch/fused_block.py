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

The planners decide where the fused stages engage, on the same knobs as
the reference: ``root.common.engine.fused_elementwise`` (blocks; stepped
aside for by the LRN-formulation knobs ``lrn_pow``/``lrn_autodiff``/
``pallas_lrn``) and ``fused_tail`` (conv bias+ReLU, FC epilogues and the
loss head).  Both are off by default.
"""

from __future__ import annotations

import ctypes
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

    kind: str                  # "conv_bias_relu" | "fc_epilogue"
    span: int                  # modules consumed
    ratio: float = 0.0         # dropout ratio (fc_epilogue only)
    dropout_index: int = -1    # forwards index of the absorbed dropout


def _check_kernel_operands(name, x, bias, *others):
    """Raise unless ``x`` is a contiguous float32 NHWC CUDA tensor with a
    matching bias, and every tensor of ``others`` is a contiguous float32
    tensor on the same device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {x.dtype}/"
                        f"{bias.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)}")
    if tuple(bias.shape) != (x.shape[-1],) or bias.device != x.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on "
                         f"{bias.device} does not match {tuple(x.shape)} "
                         f"on {x.device}")
    for t in others:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name} kernel takes contiguous float32 "
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
    W_n(r*r))``, then the max over the ky*kx strided windows."""
    ky, kx, sy, sx = pool
    _, H, W, _ = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    _, r, _, sb = _relu_lrn(x, bias, n, alpha, beta, k)
    p = None
    for win in _pool_windows(r * sb, ky, kx, sy, sx, oh, ow):
        p = win if p is None else torch.maximum(p, win)
    return p


def fused_block_bwd_plain(x, bias, dp, n=5, alpha=1e-4, beta=0.75, k=2.0,
                          pool=(3, 3, 2, 2)):
    """The plain version of K1b, the reference kernel's backward op by op
    (``pallas_fused_block._bwd_kernel``): the forward recomputed; ``g =
    dp / nt`` split equally among a window's tied maxima and scattered
    back window offset by offset (i outer, j inner); the closed-form LRN
    backward ``dr = dy*sb - (2 alpha beta)*r*W_n(dy*r*(sb/s))``; the
    strict gate ``a > 0``.  Returns ``(dx, db)``."""
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
    return da, torch.sum(da, dim=(0, 1, 2))


def _tiling_pool(x, pool):
    ky, kx, sy, sx = (int(v) for v in pool)
    _, H, W, _ = x.shape
    if (H - ky) % sy or (W - kx) % sx:
        raise ValueError(f"pool {pool} does not tile ({H}, {W}) exactly")
    return ky, kx, sy, sx


def _smem_limit(dev: int) -> int:
    return _build.entry("fused_block", "znicz_fused_block_smem_limit")(dev)


def fused_block_fwd(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                    pool=(3, 3, 2, 2)):
    """K1: fused bias+StrictRELU+LRN+maxpool over the RAW conv output
    ``x`` (B, H, W, C).  ``pool`` = (ky, kx, sy, sx) must tile (H, W)
    exactly.  CPU tensors take :func:`fused_block_plain`."""
    ky, kx, sy, sx = _tiling_pool(x, pool)
    B, H, W, C = x.shape
    if _all_cpu(x, bias):
        return fused_block_plain(x, bias, n, alpha, beta, k,
                                 (ky, kx, sy, sx))
    _check_kernel_operands("fused_block_fwd", x, bias)
    dev = x.device.index
    limit = _smem_limit(dev)
    if C > 1024 or ky * W * C * 4 > limit:
        raise ValueError(
            f"fused_block kernel: {ky} rows of {W}x{C} floats do not fit "
            f"one block's shared memory ({limit} bytes) or C > 1024")
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    out = torch.empty((B, oh, ow, C), dtype=x.dtype, device=x.device)
    rc = _build.entry("fused_block")(
        x.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, oh, ow,
        int(n), float(alpha), float(beta), float(k), ky, kx, sy, sx,
        int(float(beta) == 0.75), dev, _build.stream_of(x))
    _build.check(rc, "fused_block")
    fused_block_fwd.launches += 1
    return out


#: K1 launches since the count was last reset
fused_block_fwd.launches = 0


def fused_block_bwd(x, bias, dp, n=5, alpha=1e-4, beta=0.75, k=2.0,
                    pool=(3, 3, 2, 2)):
    """K1b: ``(dx, db)`` of :func:`fused_block_fwd` for the pooled
    cotangent ``dp``, recomputing the forward from ``(x, bias)``.  CPU
    tensors take :func:`fused_block_bwd_plain`."""
    ky, kx, sy, sx = _tiling_pool(x, pool)
    B, H, W, C = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    if tuple(dp.shape) != (B, oh, ow, C):
        raise ValueError(f"fused_block_bwd: dp {tuple(dp.shape)}, expected "
                         f"{(B, oh, ow, C)}")
    if _all_cpu(x, bias, dp):
        return fused_block_bwd_plain(x, bias, dp, n, alpha, beta, k,
                                     (ky, kx, sy, sx))
    _check_kernel_operands("fused_block_bwd", x, bias, dp)
    dev = x.device.index
    smem = ctypes.c_longlong(0)
    rows = _build.entry("fused_block_bwd", "znicz_fused_block_bwd_plan")(
        B, H, W, C, oh, ow, int(n), ky, kx, sy, sx, ctypes.byref(smem))
    limit = _smem_limit(dev)
    if C > 1024 or smem.value > limit:
        raise ValueError(
            f"fused_block_bwd kernel: {smem.value} bytes of shared memory "
            f"exceed one block's {limit}, or C > 1024")
    dx = torch.empty_like(x)
    db = torch.empty((C,), dtype=x.dtype, device=x.device)
    partial = torch.empty((max(rows, 1), C), dtype=x.dtype, device=x.device)
    rc = _build.entry("fused_block_bwd")(
        x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
        db.data_ptr(), partial.data_ptr(), B, H, W, C, oh, ow, int(n),
        float(alpha), float(beta), float(k), float(2.0 * alpha * beta),
        ky, kx, sy, sx, int(float(beta) == 0.75), dev, _build.stream_of(x))
    _build.check(rc, "fused_block_bwd")
    fused_block_bwd.launches += 1
    return dx, db


#: K1b launches since the count was last reset
fused_block_bwd.launches = 0


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
    """The plain version of K2: ``relu(x + b)``."""
    return torch.clamp_min(x + bias, 0.0)


def bias_relu_bwd_plain(x, bias, dp):
    """The plain version of K2b: ``dx = dp * [x + b > 0]`` and ``db``,
    the sum of ``dx`` over every leading axis.  Returns ``(dx, db)``."""
    da = dp * ((x + bias) > 0.0).to(dp.dtype)
    return da, torch.sum(da, dim=tuple(range(da.ndim - 1)))


def bias_relu_fwd(x, bias):
    """K2: fused bias+StrictRELU over a (B, H, W, C) conv output.  CPU
    tensors take :func:`bias_relu_plain`."""
    if x.ndim != 4:
        raise ValueError(f"fused_bias_relu expects NHWC, got {x.shape}")
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


def bias_relu_bwd(x, bias, dp):
    """K2b: ``(dx, db)`` of :func:`bias_relu_fwd` for the cotangent
    ``dp``, the gate recomputed from ``(x, bias)``.  CPU tensors take
    :func:`bias_relu_bwd_plain`."""
    if x.ndim != 4 or dp.shape != x.shape:
        raise ValueError(f"bias_relu_bwd: x {tuple(x.shape)} and dp "
                         f"{tuple(dp.shape)} must be the same NHWC shape")
    if _all_cpu(x, bias, dp):
        return bias_relu_bwd_plain(x, bias, dp)
    _check_kernel_operands("bias_relu_bwd", x, bias, dp)
    C = int(x.shape[-1])
    rows = x.numel() // C
    rpb = ctypes.c_int(0)
    blocks = _build.entry("bias_relu_bwd", "znicz_bias_relu_bwd_blocks")(
        rows, ctypes.byref(rpb))
    if C > 1024:
        raise ValueError(f"bias_relu_bwd kernel: C {C} > 1024")
    dx = torch.empty_like(x)
    db = torch.empty((C,), dtype=x.dtype, device=x.device)
    partial = torch.empty((max(blocks, 1), C), dtype=x.dtype,
                          device=x.device)
    rc = _build.entry("bias_relu_bwd")(
        x.data_ptr(), bias.data_ptr(), dp.data_ptr(), dx.data_ptr(),
        db.data_ptr(), partial.data_ptr(), rows, C, x.device.index,
        _build.stream_of(x))
    _build.check(rc, "bias_relu_bwd")
    bias_relu_bwd.launches += 1
    return dx, db


#: K2b launches since the count was last reset
bias_relu_bwd.launches = 0


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
    ``mask_of`` again for the mask (``pallas_fused_block.py:493-534``)."""

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
            da = da * ctx.mask_of()
        return da, torch.sum(da, dim=tuple(range(da.ndim - 1))), None


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
    """The FusedBlockSpec for ConvStrictRELU(+bias) -> LRN (odd window) ->
    exactly tiling MaxPooling starting at ``forwards[i]``, or None."""
    from znicz_torch.conv import Conv
    from znicz_torch.lrn import LRNormalizerForward
    from znicz_torch.ops import activations
    from znicz_torch.pooling import MaxPooling

    conv = forwards[i]
    if not isinstance(conv, Conv) or not conv.include_bias \
            or conv.ACTIVATION is not activations.strict_relu:
        return None
    if i + 2 >= len(forwards):
        return None
    lrn_u, pool_u = forwards[i + 1], forwards[i + 2]
    if not isinstance(lrn_u, LRNormalizerForward):
        return None
    hypers = lrn_u.fused_block_hypers
    if hypers is None:
        return None
    if type(pool_u) is not MaxPooling or not pool_u.exact_tiling():
        return None
    n, alpha, beta, k = hypers
    sy, sx = pool_u.sliding
    return FusedBlockSpec(span=3, n=n, alpha=alpha, beta=beta, k=k,
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
    """ConvStrictRELU(+bias) with no LRN/pool requirement: conv3-5."""
    from znicz_torch.conv import Conv
    from znicz_torch.ops import activations

    conv = forwards[i]
    if isinstance(conv, Conv) and conv.include_bias \
            and conv.ACTIVATION is activations.strict_relu:
        return FusedTailSpec("conv_bias_relu", 1)
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
            or match_fc_epilogue(forwards, i)
        if spec is not None:
            plan[i] = spec
            i += spec.span
        else:
            i += 1
    return plan
