"""Ensembles (port of ``znicz_tpu/ensemble.py``).

  - :class:`EnsembleTrainer` — runs a workflow factory ``n_models`` times
    with seeds ``base_seed + 1000 i`` (``core.prng.reset`` before each),
    keeping each member and its Decision's best metric;
  - :class:`EnsembleEvaluator` — soft voting: the members' output
    distributions averaged.  Inference composes each member's forward
    modules, whose own forwards are their eval modes (dropout the
    identity, stochastic pooling its expectation, a mean/disp normaliser
    its normalisation), under ``torch.no_grad()``, and changes nothing
    in the members.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from znicz_torch.core import prng


class EnsembleTrainer:
    """``factory(seed)`` -> a trained workflow with ``decision`` and
    ``forwards``."""

    def __init__(self, factory: Callable[[int], object], n_models: int = 3,
                 base_seed: int = 1013):
        self.factory = factory
        self.n_models = int(n_models)
        self.base_seed = int(base_seed)
        self.members: List[object] = []
        self.metrics: List[float] = []

    def run(self):
        for i in range(self.n_models):
            seed = self.base_seed + 1000 * i
            prng.reset(seed)
            wf = self.factory(seed)
            self.members.append(wf)
            self.metrics.append(float(wf.decision.best_metric))
        return self


class EnsembleEvaluator:
    """Soft voting over member workflows' forward modules."""

    def __init__(self, members: List[object]):
        self.members = list(members)

    @staticmethod
    def pure_forward(forwards, x) -> torch.Tensor:
        """The forward chain ``forwards`` (modules, or units of modules)
        on ``x``, on the first module's device.  A module's own forward
        is its eval mode: dropout's the identity, stochastic pooling's
        its expectation, ``MeanDispForward``'s the normalisation."""
        mods = [getattr(f, "module", f) for f in forwards]
        dev = next((p.device for m in mods for p in m.parameters()),
                   torch.device("cpu"))
        h = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        with torch.no_grad():
            for m in mods:
                h = m(h)
        return h

    def predict_proba(self, data: np.ndarray) -> np.ndarray:
        probs = [self.pure_forward(wf.forwards, data).float().cpu().numpy()
                 for wf in self.members]
        return np.mean(probs, axis=0)

    def n_err(self, data: np.ndarray, labels: np.ndarray) -> int:
        pred = self.predict_proba(data).argmax(-1)
        return int((pred != np.asarray(labels)).sum())
