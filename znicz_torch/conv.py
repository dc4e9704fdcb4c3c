"""Convolution forward modules (port of ``znicz_tpu/conv.py``).

NHWC activations, weights ``(n_kernels, ky, kx, channels)``, ``sliding``
(stride) and 4-sided ``padding`` (left, top, right, bottom).  The
convolution is ``F.conv2d`` on channels_last views of the NHWC tensors,
as the reference's is one ``lax.conv_general_dilated`` outside any
kernel of its own.  bf16 operands keep a bf16 output, as the
reference's do (``conv.py:63-72``).
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F

from znicz_torch.forward import ForwardModule
from znicz_torch.ops import activations


def conv_output_hw(h: int, w: int, ky: int, kx: int,
                   sliding: Tuple[int, int],
                   padding: Tuple[int, int, int, int]) -> Tuple[int, int]:
    left, top, right, bottom = padding
    sy, sx = sliding
    return ((h + top + bottom - ky) // sy + 1,
            (w + left + right - kx) // sx + 1)


class Conv(ForwardModule):
    ACTIVATION = staticmethod(activations.identity)
    has_weights = True

    def __init__(self, name=None, n_kernels=8, kx=3, ky=3, sliding=(1, 1),
                 padding=(0, 0, 0, 0), **kwargs):
        if kwargs.get("weights_transposed"):
            raise ValueError("weights_transposed is an All2All storage "
                             "option; Conv weights are always (K, ky, kx, C)")
        super().__init__(name=name, **kwargs)
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky)
        self.sliding = tuple(int(s) for s in sliding)
        self.padding = tuple(int(p) for p in padding)

    def output_shape_for(self, in_shape):
        b, h, w, c = in_shape
        oh, ow = conv_output_hw(h, w, self.ky, self.kx, self.sliding,
                                self.padding)
        return (b, oh, ow, self.n_kernels)

    def weight_shapes(self, in_shape):
        return ((self.n_kernels, self.ky, self.kx, int(in_shape[-1])),
                (self.n_kernels,))

    def apply_linear(self, x):
        """The convolution alone — no bias, no activation — over an NHWC
        tensor; returns a contiguous NHWC tensor.  The fused paths add
        their own bias and activation."""
        left, top, right, bottom = self.padding
        xn = x.permute(0, 3, 1, 2)              # NCHW view, channels_last
        if (left, top) == (right, bottom):
            pad = (top, left)
        else:
            xn = F.pad(xn, (left, right, top, bottom))
            pad = (0, 0)
        y = F.conv2d(xn, self.weights.permute(0, 3, 1, 2),
                     stride=self.sliding, padding=pad)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        y = self.apply_linear(x)
        if self.include_bias:
            y = y + self.bias
        return type(self).ACTIVATION(y)


class ConvTanh(Conv):
    ACTIVATION = staticmethod(activations.tanh_scaled)


class ConvRELU(Conv):
    """The reference's "RELU": softplus ``log(1 + e^x)``."""

    ACTIVATION = staticmethod(activations.relu_log)


class ConvStrictRELU(Conv):
    ACTIVATION = staticmethod(activations.strict_relu)
