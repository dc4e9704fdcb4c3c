"""Deconvolution, the adjoint of a convolution (port of
``znicz_tpu/deconv.py``).

A :class:`Deconv` maps a (B, OH, OW, K) map back to the input shape of
a convolution of the same geometry: weights ``(K, ky, kx, C)``,
``sliding`` and 4-sided ``padding`` as ``conv.Conv``'s.  It is
``F.conv_transpose2d`` on channels_last views, with the output padding
that reaches the target size exactly and a crop where the padding is
not symmetric; the reference takes the same function as the vjp of its
convolution.  It has no bias, and refuses ``include_bias`` and
``weights_transposed`` as the reference does.

The target (H, W, C) is, in this order, the shape of ``output_shape_from``
(an Array, usually the paired convolution's input) once it holds one,
``output_sample_shape``, or the least plane the input covers,
``(OH - 1) * sy + ky - pads``.

``weights_from=`` ties the weights to a built convolution (its module or
its unit): the Deconv then draws nothing, takes the convolution's
geometry, and its ``weights`` is the convolution's parameter, one
tensor, which both GD units update in place (``gd_deconv``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.nn.functional as F

from znicz_torch.forward import ForwardModule
from znicz_torch.ops import activations


class Deconv(ForwardModule):
    ACTIVATION = staticmethod(activations.identity)
    has_weights = True

    def __init__(self, name=None, n_kernels=8, kx=3, ky=3, sliding=(1, 1),
                 padding=(0, 0, 0, 0),
                 output_sample_shape: Optional[Tuple[int, int, int]] = None,
                 weights_from=None, **kwargs):
        if kwargs.get("weights_transposed"):
            raise ValueError("weights_transposed does not apply to Deconv")
        if kwargs.get("include_bias"):
            raise ValueError("Deconv has no bias term (reference parity); "
                             "follow with an activation/bias unit if needed")
        kwargs["include_bias"] = False
        super().__init__(name=name, **kwargs)
        tied = getattr(weights_from, "module", weights_from)
        if tied is not None:
            n_kernels, kx, ky = tied.n_kernels, tied.kx, tied.ky
            sliding, padding = tied.sliding, tied.padding
        # a plain attribute: registered, the convolution would become a
        # submodule of this module
        object.__setattr__(self, "weights_from", tied)
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky)
        self.sliding = tuple(int(s) for s in sliding)
        self.padding = tuple(int(p) for p in padding)
        self.output_sample_shape = (tuple(int(d) for d in output_sample_shape)
                                    if output_sample_shape else None)
        self.output_shape_from = None

    def target_hwc(self, in_shape) -> Tuple[int, int, int]:
        shape = (tuple(self.output_shape_from.shape)
                 if self.output_shape_from is not None else ())
        if len(shape) == 4:
            return tuple(int(d) for d in shape[1:])
        if self.output_sample_shape is not None:
            return self.output_sample_shape
        _, oh, ow, _ = in_shape
        left, top, right, bottom = self.padding
        sy, sx = self.sliding
        w = self.weights if self.weights_from is None \
            else self.weights_from.weights
        return ((oh - 1) * sy + self.ky - top - bottom,
                (ow - 1) * sx + self.kx - left - right,
                int(w.shape[3]) if w is not None else 1)

    def output_shape_for(self, in_shape):
        return (int(in_shape[0]),) + self.target_hwc(in_shape)

    def weight_shapes(self, in_shape):
        return ((self.n_kernels, self.ky, self.kx,
                 self.target_hwc(in_shape)[2]), (self.n_kernels,))

    def build(self, in_shape, device):
        """As ``ForwardModule.build``, but a tied Deconv takes the
        convolution's weight parameter itself and draws nothing."""
        if self.weights_from is None:
            return super().build(in_shape, device)
        if self.weights_from.weights is None:
            raise ValueError(f"{self.name}: tied to {self.weights_from.name}"
                             ", which is not built yet")
        self.in_shape = tuple(int(d) for d in in_shape)
        self.weights = self.weights_from.weights
        return self.output_shape_for(self.in_shape)

    def forward(self, x):
        b, oh, ow, _ = x.shape
        h, w, _ = self.target_hwc(x.shape)
        left, top, right, bottom = self.padding
        sy, sx = self.sliding
        symmetric = (left, top) == (right, bottom)
        hp, wp = h + top + bottom, w + left + right
        extra = (hp - (oh - 1) * sy - self.ky, wp - (ow - 1) * sx - self.kx)
        if not (0 <= extra[0] < sy and 0 <= extra[1] < sx):
            raise ValueError(f"{self.name}: a {oh}x{ow} input is not the "
                             f"convolution of a {h}x{w} plane")
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), self.weights.permute(0, 3, 1, 2),
            stride=self.sliding, padding=(top, left) if symmetric else 0,
            output_padding=extra)
        if not symmetric:
            y = y[:, :, top:top + h, left:left + w]
        return type(self).ACTIVATION(y.permute(0, 2, 3, 1).contiguous())


class DeconvTanh(Deconv):
    ACTIVATION = staticmethod(activations.tanh_scaled)


class DeconvSigmoid(Deconv):
    ACTIVATION = staticmethod(activations.sigmoid)
