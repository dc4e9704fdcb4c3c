"""Assorted NN units (port of ``znicz_tpu/misc_units.py``).

  - :class:`MeanDispForward` / :class:`MeanDispNormalizerUnit` — in-graph
    input normalisation, ``(x - mean) / disp`` over each sample's
    flattened values, with ``mean`` and ``disp`` set or linked (fit them
    with ``normalization.MeanDispNormalizer`` on the train split); the
    module sits in a workflow's ``forwards``, the unit runs it;
  - :class:`ZeroFiller` — a boolean mask of the weight positions to keep
    a layer, re-applied (the others zeroed) each firing: the reference's
    sparsity mask;
  - :class:`NNRollback` — watches the loss and restores the parameters
    of the best loss when the loss diverges (above ``rollback_factor``
    times the best, or not finite).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_torch.core.units import Unit
from znicz_torch.forward import ForwardModule
from znicz_torch.memory import Array
from znicz_torch.nn_units import ForwardBase, params_of


class MeanDispForward(ForwardModule):
    """``(x - mean) / disp`` over each sample's flattened values; ``mean``
    and ``disp`` (the sample's size) are set with :meth:`set_stats`."""

    def __init__(self, name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.mean: Optional[torch.Tensor] = None
        self.disp: Optional[torch.Tensor] = None

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def build(self, in_shape, device):
        self.in_shape = tuple(int(d) for d in in_shape)
        return self.output_shape_for(self.in_shape)

    def set_stats(self, mean, disp, device=None) -> None:
        self.mean, self.disp = (torch.as_tensor(np.asarray(a, np.float32),
                                                device=device)
                                for a in (mean, disp))

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1)
        return ((flat - self.mean) / self.disp).reshape(x.shape)


class MeanDispNormalizerUnit(ForwardBase):
    """The unit of a :class:`MeanDispForward` (made for it unless given):
    ``mean`` and ``disp`` are ``Array``s set or linked before
    ``initialize``."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        module = module or MeanDispForward(name=name or type(self).__name__)
        super().__init__(workflow=workflow, name=name, module=module,
                         **kwargs)
        self.mean = Array()
        self.disp = Array()

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """``{"mean", "disp"}``, carried by ``weights.params_from_jax``."""
        return {"mean": self.module.mean, "disp": self.module.disp}

    def initialize(self, device=None, **kwargs):
        if self.mean.mem is None or self.disp.mem is None:
            raise ValueError(f"{self.name}: set mean/disp before initialize")
        self.module.set_stats(self.mean.mem, self.disp.mem, device)
        super().initialize(device=device, **kwargs)

    def run(self):
        with torch.no_grad():
            self.output.devmem = self.module(
                self.input.devmem.to(self.module.mean.device))


def _module(forward):
    """The module of a forward unit, or the module itself."""
    return getattr(forward, "module", forward)


class ZeroFiller(Unit):
    """Re-zeroes the masked weight positions of each bound layer when it
    fires (after the update).  Bind with ``add_mask(forward, mask)``,
    ``mask`` a bool array of the weights' shape, True = keep."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self._masks = []                    # (module, bool tensor)

    def add_mask(self, forward, mask: np.ndarray) -> None:
        mod = _module(forward)
        mask = np.asarray(mask, bool)
        if mask.shape != tuple(mod.weights.shape):
            raise ValueError(f"{self.name}: mask {mask.shape} for weights "
                             f"{tuple(mod.weights.shape)} of {mod.name}")
        self._masks.append((mod, torch.from_numpy(mask).to(
            mod.weights.device)))

    def run(self):
        with torch.no_grad():
            for mod, keep in self._masks:
                mod.weights.masked_fill_(~keep, 0.0)


class NNRollback(Unit):
    """Divergence guard: keeps a copy of the watched layers' parameters
    at the best loss; when the observed ``loss`` exceeds
    ``rollback_factor`` x the best (or is not finite) it copies them back
    and counts ``rollbacks``."""

    def __init__(self, workflow=None, name=None, rollback_factor=4.0,
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.rollback_factor = float(rollback_factor)
        self.loss = 0.0                      # link from evaluator/decision
        self.best_loss = np.inf
        self.rollbacks = 0
        self._forwards = []
        self._best: Optional[Dict] = None

    def watch(self, *forwards) -> None:
        self._forwards.extend(_module(f) for f in forwards)

    def _snapshot(self) -> Dict:
        return {f.name: {k: p.detach().clone()
                         for k, p in params_of(f).items()}
                for f in self._forwards}

    def run(self):
        loss = float(self.loss)
        diverged = (not np.isfinite(loss)
                    or (self._best is not None
                        and loss > self.rollback_factor * self.best_loss))
        if diverged:
            if self._best is None:
                # nothing good to go back to: report, let the caller decide
                self.logger.warning(
                    "loss %.4g diverged with no good snapshot yet "
                    "(nothing to roll back to)", loss)
                return
            with torch.no_grad():
                for f in self._forwards:
                    for k, p in params_of(f).items():
                        p.copy_(self._best[f.name][k])
            self.rollbacks += 1
            self.logger.warning("loss %.4g diverged (best %.4g) -> rolled "
                                "back", loss, self.best_loss)
            return
        if loss < self.best_loss:
            self.best_loss = loss
            self._best = self._snapshot()
