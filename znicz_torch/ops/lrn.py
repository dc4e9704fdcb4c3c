"""Across-channel LRN (port of ``znicz_tpu/ops/lrn_pallas.py``): the
order-sensitive pieces shared with the fused block, the plain version of
the standalone LRN, and the wrapper of its kernel, K3 (``csrc/lrn.cu``).

    y = x * (k + alpha * sum_{j in win(c)} x_j^2) ** (-beta)

``lrn`` takes the plain version for a CPU tensor and launches the kernel
for a CUDA one.  Only the forward is ported in this slice.
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


def lrn(x, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0):
    """Standalone LRN over the last axis.  A CPU tensor takes
    :func:`lrn_plain`; a CUDA tensor launches K3 or raises."""
    if x.device.type == "cpu":
        return lrn_plain(x, n, alpha, beta, k)
    if x.device.type != "cuda":
        raise ValueError(f"lrn: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"lrn kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lrn kernel takes a contiguous tensor")
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
    lrn.launches += 1
    return y


#: K3 launches since the count was last reset
lrn.launches = 0
