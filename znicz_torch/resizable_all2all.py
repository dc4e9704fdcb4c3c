"""ResizableAll2All (port of ``znicz_tpu/resizable_all2all.py``): a fully
connected layer whose output width can grow or shrink during training.
Surviving rows keep their trained values; new rows are drawn from the
unit's own named stream with the reference's ``_fill``, so after the
same earlier draws they are the reference's bits.

:meth:`ResizableAll2All.resize` replaces the module's parameters;
:meth:`ResizableAll2AllUnit.resize` also zeroes the momentum of the GD
units of its workflow that update it, at the new shapes (the momentum of
vanished or new rows means nothing), as the reference's ``resize`` does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from znicz_torch.all2all import All2All
from znicz_torch.nn_units import (ForwardBase, GradientDescentBase,
                                  state_dtype)


class ResizableAll2All(All2All):
    def resize(self, new_width: int) -> bool:
        """Change the output width in place; returns whether it changed.
        The new ``weights`` (and ``bias``) are new ``nn.Parameter``s on the
        old ones' device, without gradients, as :meth:`build` makes
        them."""
        new_width = int(new_width)
        old = self.weights.detach().cpu().numpy()
        out_old, in_size = old.shape if not self.weights_transposed \
            else (old.shape[1], old.shape[0])
        if new_width == out_old:
            return False
        w = np.zeros((new_width, in_size), np.float32)
        keep = min(out_old, new_width)
        w[:keep] = old[:keep] if not self.weights_transposed \
            else old[:, :keep].T
        if new_width > out_old:
            stddev = self.weights_stddev or 1.0 / np.sqrt(in_size)
            w[out_old:] = self._fill((new_width - out_old, in_size),
                                     self.weights_filling, stddev)
        device = self.weights.device
        if self.weights_transposed:
            w = np.ascontiguousarray(w.T)
        self.weights = nn.Parameter(torch.from_numpy(w).to(device),
                                    requires_grad=False)
        if self.include_bias:
            b = np.zeros(new_width, np.float32)
            b[:keep] = self.bias.detach().cpu().numpy()[:keep]
            self.bias = nn.Parameter(torch.from_numpy(b).to(device),
                                     requires_grad=False)
        self.output_sample_shape = (new_width,)
        self.output_samples_number = new_width
        return True


class ResizableAll2AllUnit(ForwardBase):
    """The unit of a :class:`ResizableAll2All`."""

    def resize(self, new_width: int) -> None:
        """Resize the module and zero the velocities of every GD unit of
        the workflow whose forward is this unit, at the new shapes (a GD
        unit with no velocities yet keeps none)."""
        if not self.module.resize(new_width) or self.workflow is None:
            return
        for unit in self.workflow:
            if (isinstance(unit, GradientDescentBase)
                    and unit.forward is self and unit.velocities):
                unit.velocities = {
                    k: torch.zeros_like(p.detach(), dtype=state_dtype())
                    for k, p in self.params().items()}
