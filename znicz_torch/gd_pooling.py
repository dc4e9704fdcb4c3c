"""Pooling backward units (port of ``znicz_tpu/gd_pooling.py``).

``GDMaxPooling``, ``GDMaxAbsPooling``, ``GDStochasticPooling`` and
``GDStochasticAbsPooling`` send ``err_output`` to the input positions the
forward unit recorded (``pooling.MaxPoolingUnit``'s and
``pooling.StochasticPoolingUnit``'s ``input_offset``); ``GDAvgPooling``
is the vjp of the forward average.  Pooling has no parameters, so
``apply_gradient`` is off.
"""

from __future__ import annotations

from znicz_torch.nn_units import GradientDescentBase


class GDPooling(GradientDescentBase):
    """Base of the pooling GD units."""


class GDAvgPooling(GDPooling):
    """The vjp of the forward average: each window's gradient spread over
    its real elements."""


class GDMaxPoolingBase(GDPooling):
    """``err_output`` scattered to the recorded offsets."""

    def run(self):
        offsets = self.forward.input_offset
        if not offsets:
            raise RuntimeError(
                f"{self.name}: the paired forward recorded no pooling "
                "offsets; run the forward unit first")
        if self.need_err_input:
            fwd = self.forward
            self.err_input.devmem = fwd.module.scatter_at_offsets(
                self.err_output.devmem, offsets.devmem,
                tuple(fwd.input.devmem.shape))


class GDMaxPooling(GDMaxPoolingBase):
    pass


class GDMaxAbsPooling(GDMaxPoolingBase):
    pass


class GDStochasticPooling(GDMaxPoolingBase):
    pass


class GDStochasticAbsPooling(GDMaxPoolingBase):
    pass
