"""The fused conv-block and tail stages (port of
``znicz_tpu/pallas_fused_block.py``, forward only).

  - :func:`fused_block` — bias + StrictRELU + LRN + exactly-tiling
    max-pool in one pass, conv1/conv2 of AlexNet: kernel K1
    (``csrc/fused_block.cu``);
  - :func:`fused_bias_relu` — ``relu(x + b)``, conv3-5: kernel K2
    (``csrc/bias_relu.cu``);
  - :func:`fused_fc_epilogue` — the FC layers' bias + StrictRELU; in eval
    plain PyTorch, as the reference's is an XLA custom-vjp, not a kernel.

Each kernel wrapper takes its plain version (``*_plain``) for a CPU
tensor and launches the kernel for a CUDA tensor, or raises; it counts
its launches in ``<wrapper>.launches``.

The planners decide where the fused stages engage, on the same knobs as
the reference: ``root.common.engine.fused_elementwise`` (blocks; stepped
aside for by the LRN-formulation knobs ``lrn_pow``/``lrn_autodiff``/
``pallas_lrn``) and ``fused_tail`` (conv bias+ReLU and FC epilogues).
Both are off by default.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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


# -- K1: the conv block --------------------------------------------------------


def _pool_out_hw(h, w, ky, kx, sy, sx):
    return (h - ky) // sy + 1, (w - kx) // sx + 1


def fused_block_plain(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                      pool=(3, 3, 2, 2)):
    """The plain version of K1, the reference kernel's arithmetic op by
    op: ``r = relu(x + b)``, ``y = r * inv_pow_rsqrt(k + alpha *
    W_n(r*r))``, then the max over the ky*kx strided windows."""
    ky, kx, sy, sx = pool
    _, H, W, _ = x.shape
    oh, ow = _pool_out_hw(H, W, ky, kx, sy, sx)
    r = torch.clamp_min(x + bias, 0.0)
    s = k + alpha * windowed_channel_sum(r * r, n)
    y = r * inv_pow_rsqrt(s, beta)
    p = None
    for i in range(ky):
        for j in range(kx):
            win = y[:, i:i + (oh - 1) * sy + 1:sy,
                    j:j + (ow - 1) * sx + 1:sx, :]
            p = win if p is None else torch.maximum(p, win)
    return p


def _check_kernel_operands(name, x, bias):
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


def fused_block(x, bias, n=5, alpha=1e-4, beta=0.75, k=2.0,
                pool=(3, 3, 2, 2)):
    """Fused bias+StrictRELU+LRN+maxpool over the RAW conv output ``x``
    (B, H, W, C).  ``pool`` = (ky, kx, sy, sx) must tile (H, W) exactly —
    ``plan_fused_blocks`` guarantees it.  CPU tensors take
    :func:`fused_block_plain`; CUDA tensors launch K1."""
    ky, kx, sy, sx = (int(v) for v in pool)
    B, H, W, C = x.shape
    if (H - ky) % sy or (W - kx) % sx:
        raise ValueError(f"pool {pool} does not tile ({H}, {W}) exactly")
    if x.device.type == "cpu":
        return fused_block_plain(x, bias, n, alpha, beta, k,
                                 (ky, kx, sy, sx))
    _check_kernel_operands("fused_block", x, bias)
    dev = x.device.index
    limit = _build.entry("fused_block", "znicz_fused_block_smem_limit")(dev)
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
    fused_block.launches += 1
    return out


#: K1 launches since the count was last reset
fused_block.launches = 0


# -- K2: bias + ReLU -----------------------------------------------------------


def bias_relu_plain(x, bias):
    """The plain version of K2: ``relu(x + b)``."""
    return torch.clamp_min(x + bias, 0.0)


def fused_bias_relu(x, bias):
    """Fused bias+StrictRELU over a (B, H, W, C) conv output — the
    conv3-5 stage.  CPU tensors take :func:`bias_relu_plain`; CUDA tensors
    launch K2."""
    if x.ndim != 4:
        raise ValueError(f"fused_bias_relu expects NHWC, got {x.shape}")
    if x.device.type == "cpu":
        return bias_relu_plain(x, bias)
    _check_kernel_operands("fused_bias_relu", x, bias)
    y = torch.empty_like(x)
    rc = _build.entry("bias_relu")(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(),
        int(x.shape[-1]), x.device.index, _build.stream_of(x))
    _build.check(rc, "bias_relu")
    fused_bias_relu.launches += 1
    return y


#: K2 launches since the count was last reset
fused_bias_relu.launches = 0


def fused_fc_epilogue(y, bias):
    """The FC epilogue in eval: ``relu(y + b)``.  (Dropout masks come with
    the training slice.)"""
    return bias_relu_plain(y, bias)


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
