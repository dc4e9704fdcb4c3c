"""Parameter and velocity trees between the two packages.

:func:`params_from_jax` loads a reference parameter tree — the layout of
``FusedTrainer.extract_params`` / ``ModelRunner.params`` in the JAX
package, ``{unit_name: {"weights": array, "bias": array}}`` with numpy
(or array-like) leaves — into the port's modules of the same names;
:func:`velocities_from_jax` loads ``FusedTrainer.extract_velocities``'
tree (the same layout) into the momentum state.  The reverse,
:func:`params_to_numpy` and :func:`velocities_to_numpy`, gives numpy
trees in that layout, so both packages can start a step from one state
and be compared after it.  The
two packages store every tensor in the same layout (conv weights
``(K, ky, kx, C)``, FC weights ``(out, in)`` or ``(in, out)`` with
``weights_transposed``), so nothing is transposed on the way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _targets(workflow, velocities: bool):
    """module name -> {leaf: live tensor} for every module with weights."""
    out = {}
    for f in workflow.forwards:
        if not f.has_weights:
            continue
        leaves = {"weights": f.weights}
        if f.include_bias:
            leaves["bias"] = f.bias
        if velocities:
            vel = workflow.gds[f.name].velocities
            for key, param in leaves.items():
                if key not in vel:
                    vel[key] = torch.zeros_like(param.detach())
            leaves = {key: vel[key] for key in leaves}
        out[f.name] = leaves
    return out


def _load(tree, workflow, velocities: bool):
    mods = _targets(workflow, velocities)
    if set(tree) != set(mods):
        raise KeyError(f"parameter tree names {sorted(tree)} do not match "
                       f"the modules with weights {sorted(mods)}")
    with torch.no_grad():
        for name, leaves in tree.items():
            want = mods[name]
            if set(leaves) != set(want):
                raise KeyError(f"{name}: leaves {sorted(leaves)}, expected "
                               f"{sorted(want)}")
            for key, dst in want.items():
                src = np.array(leaves[key], dtype=np.float32)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}.{key}: shape {src.shape}, "
                                     f"expected {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(src))
    return workflow


def params_from_jax(tree: Mapping[str, Mapping[str, object]], workflow):
    """Copy ``tree`` into ``workflow``'s modules on their device.  Every
    module with weights must be covered, every name in ``tree`` must name
    one, and every shape must match.  Returns ``workflow``."""
    return _load(tree, workflow, velocities=False)


def velocities_from_jax(tree: Mapping[str, Mapping[str, object]], workflow):
    """Copy a reference velocity tree into ``workflow.gds``' momentum
    state, with :func:`params_from_jax`'s checks.  Returns ``workflow``."""
    return _load(tree, workflow, velocities=True)


def _to_numpy(workflow, velocities: bool):
    return {name: {key: t.detach().cpu().numpy().copy()
                   for key, t in leaves.items()}
            for name, leaves in _targets(workflow, velocities).items()}


def params_to_numpy(workflow) -> Dict[str, Dict[str, np.ndarray]]:
    """The parameters as a numpy tree in the reference's layout."""
    return _to_numpy(workflow, velocities=False)


def velocities_to_numpy(workflow) -> Dict[str, Dict[str, np.ndarray]]:
    """The momentum state as a numpy tree in the reference's layout
    (zeros before the first update)."""
    return _to_numpy(workflow, velocities=True)
