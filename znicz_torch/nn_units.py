"""The gradient-descent update rule and hyperparameters (port of
``_decay_grad``, ``sgd_update`` and the ``GradientDescentBase`` fields of
``znicz_tpu/nn_units.py``).

:func:`sgd_update` is the single home of the update rule: SGD with
momentum, an L1/L2 weight-decay mix and max-abs gradient clipping.  The
hyperparameters are float32 on both sides, and the arithmetic is done in
the reference's order, scalar factors first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_F = np.float32


def _decay_grad(w, weights_decay, l1_vs_l2):
    """Regularisation gradient: ``wd * (l1_vs_l2/2 * sign(w) + (1 -
    l1_vs_l2) * w)``."""
    l1 = _F(l1_vs_l2)
    return float(_F(weights_decay)) * (float(l1 * _F(0.5)) * torch.sign(w)
                                       + float(_F(1.0) - l1) * w)


def sgd_update(w, g, v, *, lr, weights_decay, l1_vs_l2, momentum, clip):
    """One update of weight ``w`` with gradient ``g`` and velocity ``v``;
    returns ``(w_new, v_new)``.  Inputs are not modified."""
    clip = _F(clip)
    if clip > 0.0:
        g = torch.clamp(g, -float(clip), float(clip))
    g = g + _decay_grad(w, weights_decay, l1_vs_l2)
    v_new = float(_F(momentum)) * v - float(_F(lr)) * g
    return w + v_new, v_new


class GradientDescent:
    """The GD hyperparameters of one weighted module, with the
    reference's names and defaults: ``learning_rate_bias`` and
    ``gradient_moment_bias`` default to their weight counterparts, the
    bias decay, ``l1_vs_l2`` and the clip to 0.  ``velocities`` holds the
    momentum state, one zero tensor per parameter until training."""

    def __init__(self, forward_name: str, learning_rate: float = 0.01,
                 learning_rate_bias: Optional[float] = None,
                 weights_decay: float = 0.0, weights_decay_bias: float = 0.0,
                 l1_vs_l2: float = 0.0, gradient_moment: float = 0.0,
                 gradient_moment_bias: Optional[float] = None,
                 gradient_clip: float = 0.0):
        self.forward_name = forward_name
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate if learning_rate_bias is None
                                   else learning_rate_bias)
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = (gradient_moment
                                     if gradient_moment_bias is None
                                     else gradient_moment_bias)
        self.gradient_clip = gradient_clip
        self.velocities: Dict[str, torch.Tensor] = {}

    def hypers(self) -> Tuple[np.float32, ...]:
        """(lr, lr_bias, wd, wd_bias, l1_vs_l2, moment, moment_bias, clip),
        the reference's ``FusedTrainer.hypers`` row."""
        return tuple(_F(v) for v in (
            self.learning_rate, self.learning_rate_bias, self.weights_decay,
            self.weights_decay_bias, self.l1_vs_l2, self.gradient_moment,
            self.gradient_moment_bias, self.gradient_clip))

    def update(self, name: str, w, g):
        """Apply :func:`sgd_update` to parameter ``name`` ("weights" or
        "bias") with the bias/weight hyper split; returns the new weight
        and stores the new velocity."""
        lr, lrb, wd, wdb, l1l2, mom, momb, clip = self.hypers()
        is_bias = name == "bias"
        w_new, self.velocities[name] = sgd_update(
            w, g, self.velocities[name], lr=lrb if is_bias else lr,
            weights_decay=wdb if is_bias else wd, l1_vs_l2=l1l2,
            momentum=momb if is_bias else mom, clip=clip)
        return w_new
