"""Dropout (port of ``znicz_tpu/dropout.py``).

The eval forward is the identity.  In training the fused trainer
multiplies by :meth:`DropoutForward.make_mask`: an inverted-scale
Bernoulli mask (keep probability ``1 - ratio``, survivors scaled by
``1/(1 - ratio)``), drawn from a ``torch.Generator`` (Philox on a GPU).
The reference draws the same distribution from threefry keys, so the two
packages' masks differ unless a test injects the reference's."""

from __future__ import annotations

import torch

from znicz_torch.forward import ForwardModule


class DropoutForward(ForwardModule):
    def __init__(self, name=None, dropout_ratio=0.5, **kwargs):
        super().__init__(name=name, **kwargs)
        self.dropout_ratio = float(dropout_ratio)

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def forward(self, x):
        return x

    @staticmethod
    def make_mask(generator: torch.Generator, shape, ratio: float):
        """``(uniform < keep) / keep`` as float32 on the generator's
        device."""
        keep = 1.0 - float(ratio)
        u = torch.rand(tuple(shape), generator=generator,
                       device=generator.device)
        return (u < keep).to(torch.float32) / keep
