"""Activation functions with the reference's exact constants (port of
``znicz_tpu/ops/activations.py``).

  - ``tanh_scaled`` — LeCun's scaled tanh ``1.7159 * tanh(0.6666 x)``;
  - ``relu_log``    — the reference's "RELU": softplus ``log(1 + e^x)``;
  - ``strict_relu`` — ``max(0, x)``;
  - ``sigmoid``, ``log_act`` (``log(x + sqrt(x^2 + 1))``), ``sincos``
    (even elements sin, odd cos), ``softmax`` over the last axis.
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


def strict_relu(x):
    """``max(x, 0)``; at x == 0 the gradient is halved between the two
    arguments, as ``jnp.maximum``'s is (``clamp_min`` would pass all of
    it)."""
    return torch.maximum(x, _ZERO)


def sigmoid(x):
    return torch.sigmoid(x)


def log_act(x):
    return torch.log(x + torch.sqrt(x * x + 1.0))


def sincos(x):
    flat = x.reshape(-1)
    even = torch.arange(flat.shape[0], device=x.device) % 2 == 0
    return torch.where(even, torch.sin(flat), torch.cos(flat)).reshape(x.shape)


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
