"""Dropout (port of ``znicz_tpu/dropout.py``).

The eval forward is the identity.  In training the fused trainer
multiplies by :meth:`DropoutForward.make_mask`: an inverted-scale
Bernoulli mask (keep probability ``1 - ratio``, survivors scaled by
``1/(1 - ratio)``), drawn from a ``torch.Generator`` (Philox on a GPU).
The reference draws the same distribution from threefry keys, so the two
packages' masks differ unless a test injects the reference's.

On the unit engine :class:`DropoutUnit` records the mask of each TRAIN
minibatch (its ``minibatch_class`` is linked from the loader) and passes
the input through on the others; :class:`DropoutBackward` multiplies by
the recorded mask.  A mask comes from ``mask_fn(step, shape, ratio)``,
``step`` counting the unit's TRAIN minibatches; by default it is drawn
from the unit's own ``core.prng`` stream as a ``torch.Generator``.  Tests
pass the reference's masks through that seam."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from znicz_torch.core import prng
from znicz_torch.forward import ForwardModule
from znicz_torch.loader.base import TRAIN
from znicz_torch.memory import Array
from znicz_torch.nn_units import ForwardBase, GradientDescentBase


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


class DropoutUnit(ForwardBase):
    """The unit of a ``DropoutForward`` module."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        super().__init__(workflow=workflow, name=name, module=module,
                         **kwargs)
        self.mask = Array()
        self.minibatch_class = TRAIN               # linked from the loader
        self.mask_fn: Optional[Callable] = None
        self._step_counter = 0

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.mask.initialize(device)

    def default_mask(self, step: int, shape, ratio: float):
        gen = prng.get(self.name).torch_generator(
            step, 0, self.input.devmem.device)
        return DropoutForward.make_mask(gen, shape, ratio)

    def run(self):
        x = self.input.devmem
        if int(self.minibatch_class) == TRAIN:
            m = (self.mask_fn or self.default_mask)(
                self._step_counter, tuple(x.shape),
                self.module.dropout_ratio)
            self._step_counter += 1
            self.output.devmem = x * m
            self.mask.devmem = m
        else:
            self.output.devmem = x
            self.mask.reset(None)


class DropoutBackward(GradientDescentBase):
    """``err_output`` times the recorded mask (the identity after an eval
    minibatch).  No parameters, so ``apply_gradient`` is off."""

    def run(self):
        mask = self.forward.mask
        err = self.err_output.devmem
        self.err_input.devmem = err * mask.devmem if mask else err
