"""Cutter: crop a region of the input plane (port of
``znicz_tpu/cutter.py``).

``padding`` is (left, top, right, bottom), as in the reference: the crop
keeps ``[top:H-bottom, left:W-right]`` of an NHWC tensor.  The backward
unit's ``err_input`` is autograd's vjp of that slice, ``err_output``
padded back with zeros; it updates nothing.
"""

from __future__ import annotations

from znicz_torch.forward import ForwardModule
from znicz_torch.nn_units import GradientDescentBase


class Cutter(ForwardModule):
    def __init__(self, name=None, padding=(0, 0, 0, 0), **kwargs):
        super().__init__(name=name, **kwargs)
        self.padding = tuple(int(p) for p in padding)

    def output_shape_for(self, in_shape):
        b, h, w, c = in_shape
        left, top, right, bottom = self.padding
        return (b, h - top - bottom, w - left - right, c)

    def forward(self, x):
        left, top, right, bottom = self.padding
        h, w = x.shape[1], x.shape[2]
        return x[:, top:h - bottom, left:w - right, :]


class GDCutter(GradientDescentBase):
    pass
