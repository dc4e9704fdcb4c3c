"""Dropout (port of ``znicz_tpu/dropout.py``).  Serving runs the eval
forward, which is the identity; masks come with the training slice."""

from __future__ import annotations

from znicz_torch.forward import ForwardModule


class DropoutForward(ForwardModule):
    def __init__(self, name=None, dropout_ratio=0.5, **kwargs):
        super().__init__(name=name, **kwargs)
        self.dropout_ratio = float(dropout_ratio)

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def forward(self, x):
        return x
