"""Across-channel LRN (port of ``znicz_tpu/ops/lrn_pallas.py``): the
order-sensitive pieces shared with the fused block, the plain versions of
the standalone LRN's forward and backward, the wrappers of their kernels
K3 (``csrc/lrn.cu``) and K3b (``csrc/lrn_bwd.cu``), and :func:`lrn`, the
op with the reference's custom vjp.

    y  = x * s^-beta,  s = k + alpha * W_n(x^2)
    dx = dy * s^-beta - 2*alpha*beta * x * W_n(((dy * x) * s^-beta) / s)

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA one, or raises; it counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from znicz_torch import _build


def windowed_channel_sum(t, n: int):
    """Sum over the n-channel window centred on the LAST axis (zero past
    the ends), added offset by offset from -n//2 to +n//2 — the reference's
    shift order, which the kernels repeat."""
    half = n // 2
    C = t.shape[-1]
    acc = None
    for j in range(n):
        o = j - half                    # acc_c += t_{c+o}
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


def lrn_plain(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
              k: float = 2.0):
    """The plain version of K3: ``x * pow(s, -beta)``, with ``pow`` (the
    standalone kernel's own formulation, not the rsqrt form)."""
    s = k + alpha * windowed_channel_sum(x * x, n)
    return x * torch.pow(s, -beta)


def lrn_bwd_plain(x, dy, n: int = 5, alpha: float = 1e-4,
                  beta: float = 0.75, k: float = 2.0):
    """The plain version of K3b, the reference kernel's arithmetic op by
    op: ``s`` recomputed from ``x``, ``t = dy * x * sb / s`` (left to
    right), ``dx = dy * sb - (2 alpha beta) * x * W_n(t)``."""
    s = k + alpha * windowed_channel_sum(x * x, n)
    sb = torch.pow(s, -beta)
    t = dy * x * sb / s
    return dy * sb - (2.0 * alpha * beta) * x * windowed_channel_sum(t, n)


def _check(name, *tensors):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: operands {tuple(t.shape)} on "
                             f"{t.device} and {tuple(x.shape)} on {x.device}")


def lrn_fwd(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
            k: float = 2.0):
    """Standalone LRN forward over the last axis.  A CPU tensor takes
    :func:`lrn_plain`; a CUDA tensor launches K3 or raises."""
    if x.device.type == "cpu":
        return lrn_plain(x, n, alpha, beta, k)
    _check("lrn_fwd", x)
    C = int(x.shape[-1])
    if C * 4 > 48 * 1024:
        raise ValueError(f"lrn kernel: {C} channels exceed one block's "
                         f"static shared memory")
    y = torch.empty_like(x)
    rc = _build.entry("lrn")(
        x.data_ptr(), y.data_ptr(), x.numel() // C, C, int(n),
        float(alpha), float(beta), float(k), x.device.index,
        _build.stream_of(x))
    _build.check(rc, "lrn")
    lrn_fwd.launches += 1
    return y


#: K3 launches since the count was last reset
lrn_fwd.launches = 0


def lrn_bwd(x, dy, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
            k: float = 2.0):
    """Standalone LRN backward: ``dx`` for the forward's input ``x`` and
    the output cotangent ``dy``.  CPU tensors take :func:`lrn_bwd_plain`;
    CUDA tensors launch K3b or raise."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return lrn_bwd_plain(x, dy, n, alpha, beta, k)
    _check("lrn_bwd", x, dy)
    C = int(x.shape[-1])
    if 3 * C * 4 > 48 * 1024:
        raise ValueError(f"lrn_bwd kernel: {C} channels exceed one block's "
                         f"static shared memory")
    dx = torch.empty_like(x)
    rc = _build.entry("lrn_bwd")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel() // C, C,
        int(n), float(alpha), float(beta), float(k),
        float(2.0 * alpha * beta), x.device.index, _build.stream_of(x))
    _build.check(rc, "lrn_bwd")
    lrn_bwd.launches += 1
    return dx


#: K3b launches since the count was last reset
lrn_bwd.launches = 0


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
        return (lrn_bwd(x, dy.contiguous(), *ctx.hypers),
                None, None, None, None)


def lrn(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0):
    """Standalone LRN with K3 forward and K3b backward (the
    ``pallas_lrn`` routing)."""
    return _LRN.apply(x, int(n), float(alpha), float(beta), float(k))
