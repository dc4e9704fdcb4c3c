"""Convolution backward units (port of ``znicz_tpu/gd_conv.py``): the vjp
of the forward convolution, which autograd takes through ``F.conv2d``'s
own backward."""

from __future__ import annotations

from znicz_torch.nn_units import GradientDescentBase


class GradientDescentConv(GradientDescentBase):
    pass


class GDTanhConv(GradientDescentConv):
    pass


class GDRELUConv(GradientDescentConv):
    pass


class GDStrictRELUConv(GradientDescentConv):
    pass
