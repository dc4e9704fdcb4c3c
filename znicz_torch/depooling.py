"""Depooling: the inverse of a pooling for decoder stacks (port of
``znicz_tpu/depooling.py``).

:class:`Depooling` is built with ``pooling_from``, the pooling *unit* it
undoes.  Its forward is input-shaped like that pooling: each value goes
to the position the paired unit selected on the same minibatch (its
``input_offset``, :meth:`pooling.PoolingBase.scatter_at_offsets`).  An
average pooling records no offsets: its depooling spreads each value
over its window as the vjp of the average does.  :class:`GDDepooling`
gathers ``err_output`` back from the recorded positions
(:meth:`pooling.PoolingBase.gather_at_offsets`), the exact adjoint, or
over an average pooling takes the average itself, the adjoint of the
spread.  Neither has parameters.
"""

from __future__ import annotations

import torch

from znicz_torch.forward import ForwardModule
from znicz_torch.nn_units import GradientDescentBase
from znicz_torch.pooling import AvgPooling


def recorded_offsets(pooling):
    """The pooling unit's ``input_offset`` tensor, or None for an average
    pooling, which records none.  Raises if the paired unit has not
    recorded them yet."""
    if isinstance(pooling.module, AvgPooling):
        return None
    offsets = getattr(pooling, "input_offset", None)
    if not offsets:
        raise RuntimeError(f"{pooling.name} recorded no pooling offsets; "
                           "run the pooling unit first")
    return offsets.devmem


class Depooling(ForwardModule):
    def __init__(self, name=None, pooling_from=None, **kwargs):
        if pooling_from is None:
            raise ValueError("Depooling needs pooling_from=<pooling unit>")
        super().__init__(name=name, **kwargs)
        self.pooling = pooling_from

    def output_shape_for(self, in_shape):
        return (int(in_shape[0]),) + tuple(self.pooling.module.in_shape[1:])

    def forward(self, x):
        pool = self.pooling.module
        shape = self.output_shape_for(x.shape)
        offsets = recorded_offsets(self.pooling)
        if offsets is not None:
            return pool.scatter_at_offsets(x, offsets, shape)
        with torch.enable_grad():
            zeros = x.new_zeros(shape, requires_grad=True)
            return torch.autograd.grad(pool(zeros), zeros, x)[0]


class GDDepooling(GradientDescentBase):
    def run(self):
        if not self.need_err_input:
            return
        pooling = self.forward.module.pooling
        offsets = recorded_offsets(pooling)
        err = self.err_output.devmem
        with torch.no_grad():
            self.err_input.devmem = (
                pooling.module(err) if offsets is None
                else pooling.module.gather_at_offsets(err, offsets))
