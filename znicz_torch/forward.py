"""The base of the port's forward modules.

What the fused trainer needs of the reference's ``nn_units.ForwardBase``: the
unit name, the ``include_bias`` and ``weights_transposed`` keywords of
the layer dicts, and the reference's weight init with its keywords
(``weights_filling``/``weights_stddev``, ``bias_filling``/``bias_stddev``):
weights uniform over ±stddev·√3 (stddev 1/√fan_in unless given), gaussian
or constant, biases constant 0 unless asked otherwise, drawn in numpy
float32 from the unit's own named stream ``core.prng.get(name)`` — the
reference's numbers, bit for bit, for the same global seed.  Parameters
are built without gradients, so a served or inspected module records no
graph; the fused trainer turns gradients on for the parameters it trains.

A module is built in two steps, as the reference's units are initialised
from a live input shape: construct it from the layer dict, then
:meth:`ForwardModule.build` it with the input shape, which creates its
parameters and returns its output shape.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from znicz_torch.core import prng
from znicz_torch.distributable import Distributable


class ForwardModule(nn.Module, Distributable):
    has_weights = False
    #: the parameter leaves of a module whose parameters are not
    #: ``weights``/``bias`` (``nn_units.params_of``); None: those two
    PARAM_NAMES = None

    def __init__(self, name: Optional[str] = None, include_bias: bool = True,
                 weights_transposed: bool = False,
                 weights_stddev: Optional[float] = None,
                 weights_filling: str = "uniform",
                 bias_stddev: Optional[float] = None,
                 bias_filling: str = "constant"):
        super().__init__()
        self.name = name or type(self).__name__
        self.include_bias = bool(include_bias)
        self.weights_transposed = bool(weights_transposed)
        self.weights_stddev = weights_stddev
        self.weights_filling = weights_filling
        self.bias_stddev = bias_stddev
        self.bias_filling = bias_filling
        self.in_shape: Tuple[int, ...] = ()
        self.weights: Optional[nn.Parameter] = None
        self.bias: Optional[nn.Parameter] = None

    def output_shape_for(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        raise NotImplementedError

    def weight_shapes(self, in_shape) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
        """(weights shape, bias shape) for a module with weights."""
        raise NotImplementedError

    def _fill(self, shape, filling: str, stddev: float) -> np.ndarray:
        """A float32 array of ``shape`` filled as the reference's
        ``ForwardBase._fill`` fills it, from the unit's named stream."""
        if filling == "uniform":
            lim = stddev * np.sqrt(3.0)
            return prng.get(self.name).uniform(-lim, lim, shape)
        if filling == "gaussian":
            return prng.get(self.name).normal(stddev, shape)
        if filling == "constant":
            return np.full(shape, stddev, np.float32)
        raise ValueError(f"unknown filling {filling!r}")

    def build(self, in_shape, device: torch.device) -> Tuple[int, ...]:
        """Create the parameters for ``in_shape`` on ``device`` — weights,
        then bias, from the unit's named stream, transposed after the fill
        when ``weights_transposed`` — and return the output shape."""
        self.in_shape = tuple(int(d) for d in in_shape)
        if self.has_weights:
            w_shape, b_shape = self.weight_shapes(self.in_shape)
            fan_in = math.prod(w_shape[1:]) or 1
            w = self._fill(w_shape, self.weights_filling,
                           self.weights_stddev or 1.0 / np.sqrt(fan_in))
            if self.weights_transposed:
                w = np.ascontiguousarray(w.T)
            self.weights = nn.Parameter(torch.from_numpy(w).to(device),
                                        requires_grad=False)
            if self.include_bias:
                b = self._fill(b_shape, self.bias_filling,
                               self.bias_stddev or 0.0)
                self.bias = nn.Parameter(torch.from_numpy(b).to(device),
                                         requires_grad=False)
        return self.output_shape_for(self.in_shape)
