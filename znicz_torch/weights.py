"""Parameter trees between the two packages.

:func:`params_from_jax` loads a reference parameter tree — the layout of
``FusedTrainer.extract_params`` / ``ModelRunner.params`` in the JAX
package, ``{unit_name: {"weights": array, "bias": array}}`` with numpy
(or array-like) leaves — into the port's modules of the same names.  The
two packages store every tensor in the same layout (conv weights
``(K, ky, kx, C)``, FC weights ``(out, in)`` or ``(in, out)`` with
``weights_transposed``), so nothing is transposed on the way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Mapping[str, object]], workflow):
    """Copy ``tree`` into ``workflow``'s modules on their device.  Every
    module with weights must be covered, every name in ``tree`` must name
    one, and every shape must match.  Returns ``workflow``."""
    mods = {f.name: f for f in workflow.forwards if f.has_weights}
    if set(tree) != set(mods):
        raise KeyError(f"parameter tree names {sorted(tree)} do not match "
                       f"the modules with weights {sorted(mods)}")
    with torch.no_grad():
        for name, leaves in tree.items():
            mod = mods[name]
            want = {"weights": mod.weights}
            if mod.include_bias:
                want["bias"] = mod.bias
            if set(leaves) != set(want):
                raise KeyError(f"{name}: leaves {sorted(leaves)}, expected "
                               f"{sorted(want)}")
            for key, param in want.items():
                src = np.array(leaves[key], dtype=np.float32)
                if tuple(src.shape) != tuple(param.shape):
                    raise ValueError(f"{name}.{key}: shape {src.shape}, "
                                     f"expected {tuple(param.shape)}")
                param.copy_(torch.from_numpy(src))
    return workflow
