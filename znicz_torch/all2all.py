"""Fully-connected forward modules (port of ``znicz_tpu/all2all.py``).

``y = activation(x @ W^T + b)`` with weights ``(out, in)`` (or
``(in, out)`` with ``weights_transposed``); an NHWC input flattens in
H, W, C order.  ``All2AllSoftmax``'s own forward is the distribution;
the fused forward pass emits its logits instead, as the reference's
does.
"""

from __future__ import annotations

import math

from znicz_torch.forward import ForwardModule
from znicz_torch.ops import activations
from znicz_torch.ops.linear import linear


class All2All(ForwardModule):
    ACTIVATION = staticmethod(activations.identity)
    has_weights = True

    def __init__(self, name=None, output_sample_shape=(), **kwargs):
        super().__init__(name=name, **kwargs)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(int(d) for d in output_sample_shape)
        self.output_samples_number = math.prod(self.output_sample_shape)

    def output_shape_for(self, in_shape):
        return (in_shape[0],) + self.output_sample_shape

    def weight_shapes(self, in_shape):
        return ((self.output_samples_number, math.prod(in_shape[1:])),
                (self.output_samples_number,))

    def forward(self, x):
        y = linear(x, self.weights, self.bias,
                   weights_transposed=self.weights_transposed)
        y = type(self).ACTIVATION(y)
        return y.reshape((x.shape[0],) + self.output_sample_shape)


class All2AllTanh(All2All):
    ACTIVATION = staticmethod(activations.tanh_scaled)


class All2AllRELU(All2All):
    """The reference's "RELU": softplus ``log(1 + e^x)``."""

    ACTIVATION = staticmethod(activations.relu_log)


class All2AllStrictRELU(All2All):
    ACTIVATION = staticmethod(activations.strict_relu)


class All2AllSigmoid(All2All):
    ACTIVATION = staticmethod(activations.sigmoid)


class All2AllSoftmax(All2All):
    ACTIVATION = staticmethod(activations.softmax)
