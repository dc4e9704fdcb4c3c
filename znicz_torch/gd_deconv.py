"""Deconvolution backward units (port of ``znicz_tpu/gd_deconv.py``): the
vjp of the forward Deconv, which autograd takes through
``F.conv_transpose2d``'s own backward.  With tied weights the update
lands in the tensor the Deconv shares with its convolution, and the
convolution's GD unit, firing later, takes its vjp at the updated
weights, as the reference's reads its forward's parameters when it runs.
"""

from __future__ import annotations

from znicz_torch.nn_units import GradientDescentBase


class GDDeconv(GradientDescentBase):
    pass


class GDDeconvTanh(GDDeconv):
    pass


class GDDeconvSigmoid(GDDeconv):
    pass
