"""Kohonen self-organizing map units (port of ``znicz_tpu/kohonen.py``).

Three non-GD units of the unit engine:

  - :class:`KohonenTrainer`, the learning rule: per minibatch, the
    winner of each real row (argmin of :meth:`KohonenBase.distances`),
    a gaussian neighbourhood on the (sy, sx) grid around it, and the
    batched update ``w += lr · Σ_b g[b, i] · (x_b − w_i) / B``; lr and σ
    decay as ``exp(-epoch / decay_epochs)``, σ no lower than 0.5.  Its
    weights are drawn uniform in ±0.1 from its named stream and updated
    in place, so a forward tied to them sees every update.  ``qerror``,
    the minibatch's mean squared quantization error, is read back to the
    host once a minibatch.
  - :class:`KohonenForward`: the winners of its input, with the per-neuron
    hit counts accumulated on the host (one read a minibatch) over the
    real rows only; its weights are the trainer's (``weights_from``) or
    its own, drawn as the reference's ``ForwardBase`` draws them.
  - :class:`KohonenDecision`: the mean qerror of each epoch
    (``epoch_qerror``); complete after ``max_epochs``.

The arithmetic follows the reference's step op for op (float32 scalars,
the expanded distance ``x² + w² − 2·x·wᵀ``), so the winners agree with
the reference's where no two neurons tie within rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from znicz_torch.core import prng
from znicz_torch.core.mutable import Bool
from znicz_torch.core.units import Unit
from znicz_torch.memory import Array

_F = np.float32


def grid_coords(sy: int, sx: int) -> np.ndarray:
    """(N, 2) float32 coordinates of the SOM grid, row-major."""
    yy, xx = np.mgrid[0:sy, 0:sx]
    return np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1).astype(_F)


class KohonenBase:
    @staticmethod
    def distances(x, w):
        """(B, N) squared L2 distances in the expanded form, summed in the
        reference's order."""
        x2 = torch.sum(torch.square(x), dim=1, keepdim=True)     # (B, 1)
        w2 = torch.sum(torch.square(w), dim=1)[None, :]          # (1, N)
        return x2 + w2 - 2.0 * (x @ w.T)

    def sample_width(self) -> int:
        """The width of one flattened sample of the linked input (the
        reference's ``input.sample_size``); a loader sizes its
        ``minibatch_data`` when it is initialised."""
        shape = self.input.shape if self.input is not None else ()
        if len(shape) < 2:
            raise ValueError(f"{self.name}: the input holds no sample yet "
                             "(initialise the loader first)")
        return int(np.prod(shape[1:]))


class KohonenForward(Unit, KohonenBase):
    """Winner indices (``output``) and the hit map (``hits``, host int64;
    ``total`` samples counted).  Link ``batch_size`` from the loader's
    ``minibatch_size`` so the padded tail rows are not counted."""

    def __init__(self, workflow=None, name=None, shape=(8, 8),
                 weights_from: Optional["KohonenTrainer"] = None,
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.sy, self.sx = int(shape[0]), int(shape[1])
        self.n_neurons = self.sy * self.sx
        self.weights_from = weights_from
        self.input: Optional[Array] = None      # linked: minibatch_data
        self.output = Array()
        self.hits = Array()
        self.total = 0
        self.batch_size: Optional[int] = None
        self._weights: Optional[torch.Tensor] = None

    @property
    def weights(self) -> torch.Tensor:
        """The trainer's weights when tied, else this unit's own."""
        return (self.weights_from.weights if self.weights_from is not None
                else self._weights)

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        self.output.initialize(device)
        self.hits.reset(np.zeros(self.n_neurons, np.int64))
        if self.weights_from is None and self._weights is None:
            d = self.sample_width()
            lim = (1.0 / np.sqrt(d)) * np.sqrt(3.0)
            w = prng.get(self.name).uniform(-lim, lim, (self.n_neurons, d))
            self._weights = torch.from_numpy(w).to(
                torch.device("cpu" if device is None else device))

    def reset_hits(self) -> None:
        self.hits.map_invalidate()[...] = 0
        self.total = 0

    def run(self):
        x = self.input.devmem
        with torch.no_grad():
            self.output.devmem = torch.argmin(
                self.distances(x.reshape(x.shape[0], -1), self.weights),
                dim=1)
        winners = self.output.map_read()
        if self.batch_size is not None:
            winners = winners[:int(self.batch_size)]
        np.add.at(self.hits.map_write(), winners, 1)
        self.total += len(winners)


class KohonenTrainer(Unit, KohonenBase):
    """Batch SOM trainer with exponentially decaying radius and lr.  Like
    a GD unit with ``apply_gradient``, it updates its ``params()`` each
    run (the unit engine counts its firings as the run's updates); it
    keeps no velocities."""

    apply_gradient = True

    def __init__(self, workflow=None, name=None, shape=(8, 8),
                 learning_rate=0.1, radius: Optional[float] = None,
                 decay_epochs=20, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.sy, self.sx = int(shape[0]), int(shape[1])
        self.n_neurons = self.sy * self.sx
        self.input: Optional[Array] = None      # linked: minibatch_data
        self.batch_size = 0                     # linked: minibatch_size
        self.epoch_number = 0                   # linked: drives the decay
        self.weights: Optional[torch.Tensor] = None
        self.learning_rate = float(learning_rate)
        self.radius0 = float(radius if radius is not None
                             else max(self.sy, self.sx) / 2.0)
        self.decay_epochs = float(decay_epochs)
        #: mean squared quantization error of the last minibatch
        self.qerror = 0.0
        self._coords: Optional[torch.Tensor] = None

    def params(self):
        return {"weights": self.weights}

    def current_lr_sigma(self):
        t = float(self.epoch_number)
        decay = np.exp(-t / self.decay_epochs)
        return (_F(self.learning_rate * decay),
                _F(max(self.radius0 * decay, 0.5)))

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        dev = torch.device("cpu" if device is None else device)
        if self.weights is None:
            d = self.sample_width()
            self.weights = torch.from_numpy(prng.get(self.name).uniform(
                -0.1, 0.1, (self.n_neurons, d))).to(dev)
        self._coords = torch.from_numpy(grid_coords(self.sy, self.sx)).to(
            self.weights.device)

    def run(self):
        lr, sigma = self.current_lr_sigma()
        two_s2 = float(_F(2.0) * sigma * sigma)
        w = self.weights
        x = self.input.devmem
        xf = x.reshape(x.shape[0], -1)
        bs = int(self.batch_size)
        denom = max(bs, 1)
        with torch.no_grad():
            valid = (torch.arange(xf.shape[0], device=xf.device)
                     < bs)[:, None]
            d = self.distances(xf, w)
            winners = torch.argmin(d, dim=1)
            qerr = torch.sum(torch.amin(d, dim=1) * valid[:, 0]) / denom
            c = self._coords
            gd = torch.sum(torch.square(c[winners][:, None, :]
                                        - c[None, :, :]), dim=-1)
            g = torch.exp(-gd / two_s2) * valid
            num = g.T @ xf
            den = torch.sum(g, dim=0)[:, None]
            w.copy_(w + float(lr) * (num - den * w) / denom)
        self.qerror = float(qerr)


class KohonenDecision(Unit):
    """Training control of the SOM loop: the mean qerror of each epoch;
    complete after ``max_epochs``."""

    def __init__(self, workflow=None, name=None, max_epochs=10, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.max_epochs = int(max_epochs)
        self.complete = Bool(False)
        self.epoch_ended = Bool(False)
        self.last_minibatch = False             # linked: loader
        self.epoch_number = 0                   # linked: loader
        self.qerror = 0.0                       # linked: trainer
        self._acc = 0.0
        self._batches = 0
        self.epoch_qerror = []
        self.on_epoch_end = []

    def run(self):
        self._acc += float(self.qerror)
        self._batches += 1
        self.epoch_ended.set(False)
        if self.last_minibatch:
            self.epoch_qerror.append(self._acc / max(1, self._batches))
            self._acc, self._batches = 0.0, 0
            self.epoch_ended.set(True)
            self.complete.set(self.epoch_number + 1 >= self.max_epochs)
            self.info("epoch %d  qerror=%.6g", self.epoch_number,
                      self.epoch_qerror[-1])
            for cb in self.on_epoch_end:
                cb(self)
