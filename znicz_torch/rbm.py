"""RBM building blocks (port of ``znicz_tpu/rbm.py``): contrastive
divergence for a binary RBM, as units.

  - :class:`Binarization` — ``output ~ Bernoulli(input)`` (inputs in [0,
    1]), drawn from the unit's own ``core.prng`` stream as a
    ``torch.Generator`` for each firing;
  - the hidden layer is an ordinary ``All2AllSigmoid`` (``h = σ(W v +
    b_h)``);
  - :class:`GradientRBM` — one CD-1 step on the hidden layer's tied
    weights and bias and its own visible bias::

        h0 ~ Bern(σ(W v0 + b_h));  v1 = σ(Wᵀ h0 + b_v);  h1 = σ(W v1 + b_h)
        ΔW ∝ h0ᵀ v0 − h1ᵀ v1;  Δb_h ∝ mean(h0 − h1);  Δb_v ∝ mean(v0 − v1)

    with the minibatch's reconstruction error ``mean ||v0 − v1||²``.

Both take a seam for their draws, as dropout does: ``sample_fn(step,
probs)`` returns the 0/1 sample of ``probs`` for the unit's ``step``-th
firing; by default it is ``torch.bernoulli`` with the stream's generator
(Philox on a GPU, where the reference draws threefry bits), so tests
inject the reference's sample.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from znicz_torch.core import prng
from znicz_torch.core.units import Unit
from znicz_torch.memory import Array


def bernoulli(name: str, step: int, probs: torch.Tensor) -> torch.Tensor:
    """A float32 0/1 sample of ``probs`` from stream ``name``'s generator
    for ``step`` on the probabilities' device."""
    gen = prng.get(name).torch_generator(step, 0, probs.device)
    return torch.bernoulli(probs.float(), generator=gen)


class Binarization(Unit):
    """``output ~ Bernoulli(input)``, one draw a firing."""

    has_weights = False

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.input: Optional[Array] = None       # linked from upstream
        self.output = Array()
        #: ``(step, probs) -> sample``; None draws :func:`bernoulli`
        self.sample_fn: Optional[Callable] = None
        self._step_counter = 0

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        self.output.initialize(device)

    def run(self):
        draw = self.sample_fn or partial(bernoulli, self.name)
        self.output.devmem = draw(self._step_counter,
                                  self.input.devmem).to(torch.float32)
        self._step_counter += 1


def cd1(w, bh, bv, v0, batch_size: int, lr: float, sample):
    """One CD-1 step: ``(w, bh, bv)`` updated with learning rate ``lr``
    and the reconstruction error, for the minibatch ``v0`` of which the
    first ``batch_size`` rows are valid.  ``sample(h0p)`` draws h0; the
    arithmetic is the reference's ``GradientRBM._step`` in its order."""
    v0 = v0.reshape(v0.shape[0], -1)
    n = v0.shape[0]
    valid = (torch.arange(n, device=v0.device)
             < batch_size)[:, None].to(v0.dtype)
    v0 = v0 * valid
    h0p = torch.sigmoid(v0 @ w.T + bh) * valid
    h0 = sample(h0p).to(v0.dtype) * valid
    v1 = torch.sigmoid(h0 @ w + bv) * valid
    h1p = torch.sigmoid(v1 @ w.T + bh) * valid
    b = max(int(batch_size), 1)
    dw = (h0p.T @ v0 - h1p.T @ v1) / b
    dbh = torch.sum(h0p - h1p, dim=0) / b
    dbv = torch.sum(v0 - v1, dim=0) / b
    rec = torch.sum(torch.square(v0 - v1)) / b
    return w + lr * dw, bh + lr * dbh, bv + lr * dbv, rec


class GradientRBM(Unit):
    """CD-1 trainer tied to a hidden ``All2AllSigmoid`` (its unit or its
    module): updates the hidden layer's ``weights`` and ``bias`` and its
    own ``vbias`` in place each firing, and keeps the minibatch's
    ``reconstruction_error``."""

    def __init__(self, workflow=None, name=None, hidden=None,
                 learning_rate=0.1, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        if hidden is None:
            raise ValueError("GradientRBM needs hidden=<All2AllSigmoid>")
        self.hidden = hidden
        self.learning_rate = float(learning_rate)
        self.input: Optional[Array] = None    # linked: v0 (minibatch_data)
        self.batch_size = 0                   # linked: minibatch_size
        self.vbias: Optional[torch.Tensor] = None
        self.reconstruction_error = 0.0
        #: ``(step, h0p) -> h0``; None draws :func:`bernoulli`
        self.sample_fn: Optional[Callable] = None
        self._step_counter = 0

    @property
    def module(self):
        return getattr(self.hidden, "module", self.hidden)

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The leaves this unit owns (the hidden layer's are its own):
        ``{"vbias": ...}``, carried by ``weights.params_from_jax``."""
        return {"vbias": self.vbias}

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        if self.vbias is None:
            size = math.prod(tuple(self.input.shape)[1:])
            self.vbias = torch.zeros(size, dtype=torch.float32,
                                     device=self.module.weights.device)

    def run(self):
        mod, step = self.module, self._step_counter
        draw = self.sample_fn or partial(bernoulli, self.name)
        with torch.no_grad():
            w, bh, bv, rec = cd1(
                mod.weights, mod.bias, self.vbias,
                self.input.devmem.to(mod.weights.device),
                int(self.batch_size), float(np.float32(self.learning_rate)),
                lambda p: draw(step, p))
            mod.weights.copy_(w)
            mod.bias.copy_(bh)
            self.vbias.copy_(bv)
        self._step_counter += 1
        self.reconstruction_error = float(rec)
