"""Fully-connected backward units (port of ``znicz_tpu/gd.py``).

``GradientDescent`` (linear), ``GDTanh``, ``GDRELU``, ``GDStrictRELU``,
``GDSigmoid`` and ``GDSoftmax``: each is the vjp of its forward module
(``nn_units.GradientDescentBase``).  ``GDSoftmax`` takes the vjp of the
linear part only, because the evaluator's ``err_output = softmax -
target`` is already the cross-entropy cotangent at the logits.
"""

from __future__ import annotations

from znicz_torch.nn_units import GradientDescentBase
from znicz_torch.ops.linear import linear


class GradientDescent(GradientDescentBase):
    """Backward of any All2All kind: the vjp of its forward."""


class GDTanh(GradientDescent):
    pass


class GDRELU(GradientDescent):
    pass


class GDStrictRELU(GradientDescent):
    pass


class GDSigmoid(GradientDescent):
    pass


class GDSoftmax(GradientDescent):
    """``err_output`` is d(CE)/d(logits): the vjp bypasses the softmax."""

    def backward_apply(self, x):
        m = self.forward.module
        y = linear(x, m.weights, m.bias,
                   weights_transposed=m.weights_transposed)
        return y.reshape((x.shape[0],) + m.output_sample_shape)
