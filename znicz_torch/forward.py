"""The base of the port's forward modules.

What the fused trainer needs of the reference's ``nn_units.ForwardBase``: the
unit name, the ``include_bias`` and ``weights_transposed`` keywords of
the layer dicts, and the reference's default weight init — uniform over
±sqrt(3/fan_in) (standard deviation 1/sqrt(fan_in)), biases 0.  Random
numbers come from an explicit ``torch.Generator``; they are not the
reference's numbers (``weights.params_from_jax`` carries those over).
Parameters are built without gradients, so a served or inspected
module records no graph; the fused trainer turns gradients on for the
parameters it trains.

A module is built in two steps, as the reference's units are initialised
from a live input shape: construct it from the layer dict, then
:meth:`ForwardModule.build` it with the input shape, which creates its
parameters and returns its output shape.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class ForwardModule(nn.Module):
    has_weights = False

    def __init__(self, name: Optional[str] = None, include_bias: bool = True,
                 weights_transposed: bool = False):
        super().__init__()
        self.name = name or type(self).__name__
        self.include_bias = bool(include_bias)
        self.weights_transposed = bool(weights_transposed)
        self.in_shape: Tuple[int, ...] = ()
        self.weights: Optional[nn.Parameter] = None
        self.bias: Optional[nn.Parameter] = None

    def output_shape_for(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        raise NotImplementedError

    def weight_shapes(self, in_shape) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
        """(weights shape, bias shape) for a module with weights."""
        raise NotImplementedError

    def build(self, in_shape, generator: torch.Generator,
              device: torch.device) -> Tuple[int, ...]:
        """Create the parameters for ``in_shape`` on ``device`` from
        ``generator``; return the output shape."""
        self.in_shape = tuple(int(d) for d in in_shape)
        if self.has_weights:
            w_shape, b_shape = self.weight_shapes(self.in_shape)
            lim = math.sqrt(3.0 / (math.prod(w_shape[1:]) or 1))
            w = torch.rand(w_shape, generator=generator, device=device)
            w = w * (2.0 * lim) - lim
            if self.weights_transposed:
                w = w.t().contiguous()
            self.weights = nn.Parameter(w, requires_grad=False)
            if self.include_bias:
                self.bias = nn.Parameter(
                    torch.zeros(b_shape, device=device), requires_grad=False)
        return self.output_shape_for(self.in_shape)
