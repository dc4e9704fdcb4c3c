"""Activation functions with the reference's exact constants (port of
``znicz_tpu/ops/activations.py``).

  - ``tanh_scaled`` — LeCun's scaled tanh ``1.7159 * tanh(0.6666 x)``;
  - ``relu_log``    — the reference's "RELU": softplus ``log(1 + e^x)``;
  - ``strict_relu`` — ``max(0, x)``;
  - ``sigmoid``, ``log_act`` (``log(x + sqrt(x^2 + 1))``), ``sincos``
    (even elements sin, odd cos), ``softmax`` over the last axis;
  - ``tanhlog`` — ``tanh_scaled`` inside |x| < 10, the log tail
    ``sign(x) * (1.7159 + log(max(|x| - 9, 1)))`` outside (the reference
    keeps it in ``znicz_tpu/activation.py`` as ``_tanhlog``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TANH_A = 1.7159
TANH_B = 0.6666


def tanh_scaled(x):
    return TANH_A * torch.tanh(TANH_B * x)


def relu_log(x):
    return F.softplus(x)


#: a 0-dim CPU zero: a scalar operand on any device, with no fill launch
_ZERO = torch.zeros(())
_ONE = torch.ones(())


def strict_relu(x):
    """``max(x, 0)``; at x == 0 the gradient is halved between the two
    arguments, as ``jnp.maximum``'s is (``clamp_min`` would pass all of
    it)."""
    return torch.maximum(x, _ZERO)


def sigmoid(x):
    return torch.sigmoid(x)


class _Sqrt(torch.autograd.Function):
    """``sqrt`` whose gradient is ``g * (0.5 / sqrt(x))``, jax's rule
    (autograd's ``g / (2 * sqrt(x))`` rounds differently)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.sqrt(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (0.5 / s)


def log_act(x):
    """``log(x + sqrt(x^2 + 1))``.  For x < 0 the sum cancels, and its
    gradient with it: each operation's vjp is the reference's, so that
    the cancellation meets the same roundings."""
    return torch.log(x + _Sqrt.apply(torch.square(x) + 1.0))


def sincos(x):
    flat = x.reshape(-1)
    even = torch.arange(flat.shape[0], device=x.device) % 2 == 0
    return torch.where(even, torch.sin(flat), torch.cos(flat)).reshape(x.shape)


def tanhlog(x):
    """The reference's TanhLog: ``tanh_scaled`` for |x| < 10, the log tail
    outside; at |x| == 10 the ``max`` ties and, as ``jnp.maximum``'s, its
    gradient splits in half."""
    tail = torch.sign(x) * (TANH_A + torch.log(
        torch.maximum(torch.abs(x) - 9.0, _ONE)))
    return torch.where(torch.abs(x) < 10.0, tanh_scaled(x), tail)


def softmax(x):
    return torch.softmax(x, dim=-1)


def identity(x):
    return x


#: name -> fn registry, as in the reference.
ACTIVATIONS = {
    "linear": identity,
    "tanh": tanh_scaled,
    "relu": relu_log,
    "strict_relu": strict_relu,
    "sigmoid": sigmoid,
    "log": log_act,
    "sincos": sincos,
    "softmax": softmax,
}
