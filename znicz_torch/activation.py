"""Standalone activation layers (port of ``znicz_tpu/activation.py``).

``ActivationForward`` applies its class's ``ACTIVATION`` and has no
parameters; the seven pairs are Tanh, Sigmoid, RELU (the reference's
softplus), StrictRELU, Log, SinCos and TanhLog, each a module with a
backward unit (``Backward*``) whose ``err_input`` is autograd's vjp of
the forward, as the reference's is ``jax.vjp``'s.  The backward units
update nothing (``apply_gradient`` off).

:class:`ForwardMul` is the unit of the reference's two-input gate: its
``output`` is ``input * x2``, ``x2`` linked from another unit.

:func:`is_strict_relu_unit` is what the fusion planners use to absorb a
plain ``Conv`` followed by a StrictRELU layer into the same kernels as a
``ConvStrictRELU`` (``fused_block.match_fused_block``,
``match_conv_bias_relu``).
"""

from __future__ import annotations

from typing import Optional

import torch

from znicz_torch.forward import ForwardModule
from znicz_torch.memory import Array
from znicz_torch.nn_units import ForwardBase, GradientDescentBase
from znicz_torch.ops import activations


class ActivationForward(ForwardModule):
    ACTIVATION = staticmethod(activations.identity)

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def forward(self, x):
        return type(self).ACTIVATION(x)


class ActivationBackward(GradientDescentBase):
    """The vjp of an activation (no parameters, so ``apply_gradient`` is
    off)."""


def is_strict_relu_unit(module) -> bool:
    """True for a standalone StrictRELU activation module (parameter
    free), the layer the planners absorb after a plain ``Conv``."""
    return (isinstance(module, ActivationForward)
            and type(module).ACTIVATION is activations.strict_relu)


def _make(name, fn):
    fwd = type(f"Forward{name}", (ActivationForward,),
               {"ACTIVATION": staticmethod(fn)})
    bwd = type(f"Backward{name}", (ActivationBackward,), {})
    return fwd, bwd


ForwardTanh, BackwardTanh = _make("Tanh", activations.tanh_scaled)
ForwardSigmoid, BackwardSigmoid = _make("Sigmoid", activations.sigmoid)
ForwardRELU, BackwardRELU = _make("RELU", activations.relu_log)
ForwardStrictRELU, BackwardStrictRELU = _make(
    "StrictRELU", activations.strict_relu)
ForwardLog, BackwardLog = _make("Log", activations.log_act)
ForwardSinCos, BackwardSinCos = _make("SinCos", activations.sincos)
ForwardTanhLog, BackwardTanhLog = _make("TanhLog", activations.tanhlog)


class Mul(ForwardModule):
    """The elementwise product of two same-shaped inputs."""

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def forward(self, x, x2):
        return x * x2


class ForwardMul(ForwardBase):
    """The unit of a :class:`Mul`: ``output = input * x2``, both linked
    from upstream units."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        super().__init__(workflow=workflow, name=name,
                         module=module or Mul(name=name), **kwargs)
        self.x2: Optional[Array] = None

    def run(self):
        with torch.no_grad():
            self.output.devmem = self.module(self.input.devmem,
                                             self.x2.devmem)
