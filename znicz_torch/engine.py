"""Engine selection for a built workflow (port of ``znicz_tpu/engine.py``'s
local branch): the unit-at-a-time graph engine (``Workflow.run``), the
reference's default, or ``FusedTrainer``, chosen by
``root.common.engine.fused`` (``python -m znicz_torch --fused``) or by the
caller's ``fused``.

:func:`train` also measures the run.  ``workflow.train_stats`` gets
``train_steps`` (updates applied), ``img_per_sec`` (TRAIN images served
over the wall time of the run, the device synchronised at its end) and
``warm_img_per_sec``: for ``FusedTrainer`` after each kind of step's
first call (``FusedTrainer.stats``); for the unit engine after the first
epoch's end.  On the unit engine the updates are the firings of the head
of the GD chain, or of the first unit with ``apply_gradient`` set in a
graph wired by hand (MnistAE's ``gd_deconv``, the SOM's trainer).

A graph the fused trainer cannot run (tied weights:
``FusedUnsupportedError``) trains on the unit engine on the same device,
with a warning, as the reference's does; any other error propagates.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from znicz_torch.core.config import check_engine_knobs, root
from znicz_torch.loader.base import TRAIN

log = logging.getLogger("znicz_torch.engine")


def wants_fused() -> bool:
    return bool(root.common.engine.get("fused", False))


def _fused_capable(workflow, fused: bool) -> bool:
    """The fused trainer applies: asked for, and the graph has the
    ``StandardWorkflow`` shape it needs."""
    return fused and all(getattr(workflow, a, None) is not None
                         for a in ("forwards", "gds", "loader", "decision"))


def train(workflow, fused: Optional[bool] = None, mesh=None):
    """Train ``workflow`` until its Decision completes, with
    ``FusedTrainer`` when ``fused`` (default: :func:`wants_fused`) and
    the graph allows it, else with the unit graph.  The fused trainer
    runs on ``mesh``, by default the training mesh of the config
    (``parallel.mesh.train_mesh_from_config``, None unless
    ``root.common.engine.train_shard``); the unit graph refuses a mesh.
    Returns the stats dict also kept as ``workflow.train_stats``.  A
    reference knob the port does not read yet, such as the master and
    slave roles (``root.common.engine.mode``), raises
    (:func:`check_engine_knobs`)."""
    from znicz_torch.parallel.mesh import train_mesh_from_config

    check_engine_knobs()
    if mesh is None:
        mesh = train_mesh_from_config()
    trainer = None
    if _fused_capable(workflow, wants_fused() if fused is None else fused):
        from znicz_torch.parallel.fused import (FusedTrainer,
                                                FusedUnsupportedError)

        try:
            trainer = FusedTrainer(workflow, mesh=mesh)
        except FusedUnsupportedError as exc:
            log.warning("the fused trainer cannot run %s (%s); training on "
                        "the unit engine", workflow.name, exc)
    if trainer is None and mesh is not None:
        raise ValueError(f"{workflow.name}: the unit engine trains on one "
                         "device; a mesh needs the fused trainer")
    if trainer is not None:
        trainer.run()
        workflow.trainer = trainer
        stats = {k: trainer.stats[k] for k in
                 ("train_steps", "img_per_sec", "warm_img_per_sec")}
    else:
        stats = _run_units(workflow)
    workflow.train_stats = stats
    return stats


def update_unit(workflow):
    """The unit whose firings are the run's updates: the head of the GD
    chain (``gd_units``), else the first unit with ``apply_gradient`` set
    (a GD unit that updates parameters, or the SOM's trainer)."""
    chain = getattr(workflow, "gd_units", None)
    if chain:
        return chain[0]
    for unit in workflow:
        if getattr(unit, "apply_gradient", False):
            return unit
    raise ValueError(f"{workflow.name}: no unit applies an update")


def _run_units(workflow):
    """``workflow.run()`` with its TRAIN images, updates
    (:func:`update_unit`'s firings) and wall time."""
    loader, decision = workflow.loader, workflow.decision
    updater = update_unit(workflow)

    def count():
        return loader.class_samples_served[TRAIN], updater.run_count

    epoch_end = []

    def mark(_):
        if not epoch_end:
            epoch_end.append((time.perf_counter(), count()[0]))

    (images0, steps0), t0 = count(), time.perf_counter()
    decision.on_epoch_end.append(mark)
    try:
        workflow.run()
        if workflow.device.type == "cuda":
            torch.cuda.synchronize(workflow.device)
    finally:
        decision.on_epoch_end.remove(mark)
    t1 = time.perf_counter()
    images, steps = count()
    warm = 0.0
    if epoch_end and t1 > epoch_end[0][0]:
        warm = (images - epoch_end[0][1]) / (t1 - epoch_end[0][0])
    return {"train_steps": steps - steps0,
            "img_per_sec": (images - images0) / max(t1 - t0, 1e-9),
            "warm_img_per_sec": warm}
