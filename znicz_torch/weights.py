"""Parameter and velocity trees between the two packages.

:func:`params_from_jax` loads a reference parameter tree — the layout of
``FusedTrainer.extract_params`` / ``ModelRunner.params`` in the JAX
package, ``{unit_name: {"weights": array, "bias": array}}`` with numpy
(or array-like) leaves — into the port's modules of the same names;
:func:`velocities_from_jax` loads ``FusedTrainer.extract_velocities``'
tree (the same layout) into the momentum state.  The reverse,
:func:`params_to_numpy` and :func:`velocities_to_numpy`, gives numpy
trees in that layout, so both packages can start a step from one state
and be compared after it.  Leaves load into the live tensors' dtypes and
come back as float32 (a bf16 velocity or parameter widens exactly).  The
two packages store every tensor in the same layout (conv weights
``(K, ky, kx, C)``, FC weights ``(out, in)`` or ``(in, out)`` with
``weights_transposed``), so nothing is transposed on the way.

The trees cover every unit with parameters, by unit name: a
``StandardWorkflow``'s forward units and the units of a graph wired by
hand, such as MnistAE's ``conv`` and ``deconv``, whose ``weights`` are
one tensor (both leaves load into it, and must agree), and the SOM's
``trainer``.  A unit that keeps state of its own beside a layer's
(``state_tensors()``: ``GradientRBM``'s ``vbias``,
``MeanDispNormalizerUnit``'s ``mean`` and ``disp``) is covered under its
own name with those leaves.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from znicz_torch.nn_units import GradientDescentBase, state_dtype


def _targets(workflow, velocities: bool):
    """unit name -> {leaf: live tensor} for every unit with parameters
    (each unit whose ``params()`` is not empty, so a hand-wired graph is
    covered as a ``StandardWorkflow`` is); with ``velocities``, the
    momentum state that the GD unit of each of them keeps (a unit that
    updates its own parameters, as the SOM's trainer, keeps none).  A
    tied parameter is one tensor under both names."""
    gd_of = {u.forward.name: u for u in workflow
             if isinstance(u, GradientDescentBase)}
    out = {}
    for unit in workflow:
        leaves = dict(unit.params() if hasattr(unit, "params") else {})
        if not velocities and hasattr(unit, "state_tensors"):
            leaves.update(unit.state_tensors())
        if not leaves:
            continue
        if velocities:
            if unit.name not in gd_of:
                continue
            vel = gd_of[unit.name].velocities
            for key, param in leaves.items():
                if key not in vel:
                    vel[key] = torch.zeros_like(param.detach(),
                                                dtype=state_dtype())
            leaves = {key: vel[key] for key in leaves}
        out[unit.name] = leaves
    return out


def _load(tree, workflow, velocities: bool):
    mods = _targets(workflow, velocities)
    if set(tree) != set(mods):
        raise KeyError(f"parameter tree names {sorted(tree)} do not match "
                       f"the modules with weights {sorted(mods)}")
    loaded = {}                  # id(tensor) -> the leaf first copied in
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
                first = loaded.setdefault(id(dst), (f"{name}.{key}", src))
                if first[1] is not src and not np.array_equal(first[1], src):
                    raise ValueError(f"{name}.{key} is tied to {first[0]} "
                                     "but the tree gives it other values")
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
    """float32 leaves: a bf16-stored tensor is widened, exactly."""
    return {name: {key: t.detach().float().cpu().numpy().copy()
                   for key, t in leaves.items()}
            for name, leaves in _targets(workflow, velocities).items()}


def params_to_numpy(workflow) -> Dict[str, Dict[str, np.ndarray]]:
    """The parameters as a numpy tree in the reference's layout."""
    return _to_numpy(workflow, velocities=False)


def velocities_to_numpy(workflow) -> Dict[str, Dict[str, np.ndarray]]:
    """The momentum state as a numpy tree in the reference's layout
    (zeros before the first update)."""
    return _to_numpy(workflow, velocities=True)
