"""Local response normalisation (port of ``LRNormalizerForward``
in ``znicz_tpu/lrn.py``).

``y = x / (k + alpha * sum_{j in window(c)} x_j^2) ^ beta`` over a window
of ``n`` adjacent channels centred on c; defaults alpha=1e-4, beta=0.75,
n=5, k=2.  The same knobs as the reference pick the formulation, read at
call time:

  - ``root.common.engine.pallas_lrn``: the standalone LRN kernels (K3
    forward, K3b backward, ``ops.lrn.lrn``), ``pow`` formulation;
  - otherwise, for an odd window, the composed ``lrn_ref`` with
    ``s^-0.75`` in the rsqrt form (``lrn_pow`` forces plain ``pow``) and
    the closed-form backward;
  - ``lrn_autodiff`` or an even window: the shifted-slices formulation
    ``x / pow(k + alpha * acc, beta)``, differentiated by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from znicz_torch.core.config import root
from znicz_torch.forward import ForwardModule
from znicz_torch.ops import lrn as lrn_ops


def _inv_pow(s, beta: float):
    """``s ** -beta``; beta=0.75 in the rsqrt form unless ``lrn_pow``."""
    if beta == 0.75 and not bool(root.common.engine.get("lrn_pow", False)):
        return lrn_ops.inv_pow_rsqrt(s, beta)
    return torch.pow(s, -beta)


class _LRNRef(torch.autograd.Function):
    """The composed LRN of an odd window with the reference's closed-form
    vjp (``znicz_tpu/lrn.py:68-94``): ``x`` is the only residual, ``s``
    is recomputed in the backward, and

        dx = dy * s^-beta - 2*alpha*beta * x * W_n(dy * x * (s^-beta / s))

    Plain PyTorch: the reference's is an XLA custom vjp, not a kernel."""

    @staticmethod
    def forward(ctx, x, n, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hypers = (n, alpha, beta, k)
        s = k + alpha * lrn_ops.windowed_channel_sum(x * x, n)
        return x * _inv_pow(s, beta)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        n, alpha, beta, k = ctx.hypers
        s = k + alpha * lrn_ops.windowed_channel_sum(x * x, n)
        r = _inv_pow(s, beta)
        t = dy * x * (r / s)
        dx = dy * r - (2.0 * alpha * beta) * x * \
            lrn_ops.windowed_channel_sum(t, n)
        return dx, None, None, None, None


def lrn_ref(x, n: int, alpha: float, beta: float, k: float):
    """The composed LRN of an odd window, with its closed-form backward."""
    return _LRNRef.apply(x, int(n), float(alpha), float(beta), float(k))


class LRNormalizerForward(ForwardModule):
    def __init__(self, name=None, alpha=1e-4, beta=0.75, n=5, k=2.0,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.n = int(n)
        self.k = float(k)

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    @property
    def fused_block_hypers(self):
        """(n, alpha, beta, k) when the fused block kernel can express this
        module (odd windows only), else None."""
        if self.n % 2 == 1:
            return (self.n, self.alpha, self.beta, self.k)
        return None

    def forward(self, x):
        eng = root.common.engine
        if bool(eng.get("pallas_lrn", False)):
            return lrn_ops.lrn(x, self.n, self.alpha, self.beta, self.k)
        if self.n % 2 == 1 and not bool(eng.get("lrn_autodiff", False)):
            return lrn_ref(x, self.n, self.alpha, self.beta, self.k)
        half = self.n // 2
        padded = F.pad(x * x, (half, half))
        acc = torch.zeros_like(x)
        for j in range(self.n):
            acc = acc + padded[..., j:j + x.shape[-1]]
        return x / torch.pow(self.k + self.alpha * acc, self.beta)
