"""The gradient-descent update rule, its hyperparameters, and the unit
faces of the modules (port of ``znicz_tpu/nn_units.py``).

:func:`sgd_update` is the single home of the update rule: SGD with
momentum, an L1/L2 weight-decay mix and max-abs gradient clipping.  The
hyperparameters are float32 on both sides, and the arithmetic is done in
the reference's order, scalar factors first.

The unit engine's two bases:

  - :class:`ForwardBase` is the unit of one built ``ForwardModule``: it
    holds the module (whose parameters both engines train), reads
    ``input`` and writes ``output`` as ``memory.Array``s.  Its forward
    runs under ``torch.no_grad()``, so no minibatch builds a graph there.
  - :class:`GradientDescentBase` is the backward twin of a forward unit:
    it takes ``err_output``, gives ``err_input`` (unless
    ``need_err_input`` is off) and, when ``apply_gradient`` is set,
    updates the forward's parameters in place.  It is a
    :class:`GradientDescent`, so its hyperparameters and ``velocities``
    are the ones ``FusedTrainer`` reads.  The gradient is the vjp of the
    forward, recomputed here from the forward's detached input by
    ``torch.autograd.grad``, as the reference's ``jax.vjp`` recomputes it:
    no graph spans two units.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from znicz_torch.core.units import Unit
from znicz_torch.distributable import Distributable
from znicz_torch.memory import Array

_F = np.float32


def _scalar(x):
    """A hyperparameter as the update multiplies by it: a 0-dim float32
    tensor as it is (on the device, so a captured step reads the row of
    its replay), anything else as the float of its float32 value."""
    return x if isinstance(x, torch.Tensor) else float(_F(x))


def _decay_grad(w, weights_decay, l1_vs_l2):
    """Regularisation gradient: ``wd * (l1_vs_l2/2 * sign(w) + (1 -
    l1_vs_l2) * w)``, the factors rounded to float32 as the reference
    rounds them (a tensor ``l1_vs_l2`` computes them in float32)."""
    if isinstance(l1_vs_l2, torch.Tensor):
        half, rest = l1_vs_l2 * 0.5, 1.0 - l1_vs_l2
    else:
        l1 = _F(l1_vs_l2)
        half, rest = float(l1 * _F(0.5)), float(_F(1.0) - l1)
    return _scalar(weights_decay) * (half * torch.sign(w) + rest * w)


def state_dtype() -> torch.dtype:
    """The velocities' storage dtype, ``root.common.engine.state_dtype``:
    ``"float32"`` (default) or ``"bfloat16"``, which rounds each stored
    velocity to bf16 once a step while the update arithmetic stays
    float32 (:func:`sgd_update`).  Any other value raises."""
    from znicz_torch.core.config import root

    name = root.common.engine.get("state_dtype", "float32")
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(
        f"root.common.engine.state_dtype={name!r}: must be 'float32' or "
        "'bfloat16'")


def sgd_update(w, g, v, *, lr, weights_decay, l1_vs_l2, momentum, clip):
    """One update of weight ``w`` with gradient ``g`` and velocity ``v``;
    returns ``(w_new, v_new)``.  Inputs are not modified.  ``v`` may be
    stored in a narrower dtype (:func:`state_dtype`): the arithmetic runs
    in ``w``'s dtype, the new weight takes the unrounded velocity, and the
    new velocity is returned in ``v``'s own dtype.

    Each hyperparameter is a number or a 0-dim float32 tensor (the fused
    trainer's per-step rows on the device); both give the same bits.  A
    tensor ``clip`` clamps where it is positive without asking the host."""
    if isinstance(clip, torch.Tensor):
        g = torch.where(clip > 0.0, torch.clamp(g, -clip, clip), g)
    else:
        clip = _F(clip)
        if clip > 0.0:
            g = torch.clamp(g, -float(clip), float(clip))
    g = g + _decay_grad(w, weights_decay, l1_vs_l2)
    v_new = _scalar(momentum) * v.to(w.dtype) - _scalar(lr) * g
    return w + v_new, v_new.to(v.dtype)


class GradientDescent(Distributable):
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
        #: the hyperparameters as configured (the workflow digest's; a
        #: ``lr_adjust`` schedule rewrites the live ones)
        self.initial_hypers: Tuple[float, ...] = tuple(
            float(v) for v in self.hypers())

    def _payload_tensors(self) -> Dict[str, torch.Tensor]:
        """A GD unit's distributable state is its momentum (the forward
        owns the weights)."""
        return dict(self.velocities)

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


def params_of(module) -> Dict[str, torch.Tensor]:
    """``{"weights": ..., "bias": ...}`` of a module with weights (no
    bias leaf without ``include_bias``), or the leaves its
    ``PARAM_NAMES`` lists (the attention modules' projections and
    tables); ``{}`` for one without weights."""
    if not module.has_weights:
        return {}
    names = getattr(module, "PARAM_NAMES", None)
    if names:
        return {k: getattr(module, k) for k in names}
    out = {"weights": module.weights}
    if module.include_bias:
        out["bias"] = module.bias
    return out


class ForwardBase(Unit):
    """The unit of a built ``ForwardModule`` (``module``), named after it:
    ``output = module(input)``."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        super().__init__(workflow=workflow, name=name or module.name,
                         **kwargs)
        self.module = module
        self.input: Optional[Array] = None      # linked from upstream
        self.output = Array()

    @property
    def has_weights(self) -> bool:
        return self.module.has_weights

    def params(self) -> Dict[str, torch.Tensor]:
        return params_of(self.module)

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        self.output.initialize(device)

    def run(self):
        with torch.no_grad():
            self.output.devmem = self.module(self.input.devmem)


class GradientDescentBase(Unit, GradientDescent):
    """The backward unit of ``forward`` (a :class:`ForwardBase`), with the
    reference's hyperparameter names and defaults (:class:`GradientDescent`)
    and its ``apply_gradient`` (default: whether the forward has
    parameters) and ``need_err_input`` switches."""

    def __init__(self, workflow=None, name=None, forward=None,
                 apply_gradient: Optional[bool] = None,
                 need_err_input: bool = True, **hypers):
        Unit.__init__(self, workflow=workflow, name=name)
        GradientDescent.__init__(self, forward.name, **hypers)
        self.forward = forward
        self.err_output: Optional[Array] = None  # linked from downstream
        self.err_input = Array()
        self.apply_gradient = bool(forward.has_weights
                                   if apply_gradient is None
                                   else apply_gradient)
        self.need_err_input = bool(need_err_input)

    def initialize(self, device=None, **kwargs):
        super().initialize(**kwargs)
        self.err_input.initialize(device)
        self.init_velocities()

    def init_velocities(self) -> None:
        """A zero velocity for every parameter of the forward without
        one."""
        for k, p in self.forward.params().items():
            if k not in self.velocities:
                self.velocities[k] = torch.zeros_like(p.detach(),
                                                      dtype=state_dtype())

    def backward_apply(self, x):
        """The function whose vjp is this unit's backward: the forward
        module's."""
        return self.forward.module(x)

    def run(self):
        params = self.forward.params() if self.apply_gradient else {}
        if not params and not self.need_err_input:
            return
        x = self.forward.input.devmem.detach()
        with torch.enable_grad():
            x.requires_grad_(self.need_err_input)
            for p in params.values():
                p.requires_grad_(True)
            wrt = ([x] if self.need_err_input else []) + list(params.values())
            grads = list(torch.autograd.grad(self.backward_apply(x), wrt,
                                             self.err_output.devmem))
        if self.need_err_input:
            self.err_input.devmem = grads.pop(0)
        if params:
            self.init_velocities()
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    p.copy_(self.update(k, p, g))
