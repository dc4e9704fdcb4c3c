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

``root.common.engine.mode`` (``--master``/``--slave``) takes the
asynchronous parameter-server roles instead of local training: ``master``
serves the workflow's job stream (``server.Server`` at ``master_bind``,
resuming from ``master_resume`` when that file exists) and prints
``master serving <workflow> at <endpoint>``; ``slave`` works for the
master (or a relay of its tree) at ``slave_endpoint`` with a
``client.FusedClient`` when the fused trainer applies, else the
unit-engine ``client.Client``.  Under ``train_shard`` the slave is a
meshed ``FusedClient`` of this process's group (every rank calls
:func:`train`; rank 0 talks to the master).  The server or client is
kept as ``workflow.server`` / ``workflow.client``.
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
    reference knob the port does not read yet, such as
    ``obs_slo_apply_progress``, raises (:func:`check_engine_knobs`)."""
    from znicz_torch.parallel.mesh import train_mesh_from_config

    check_engine_knobs()
    mode = root.common.engine.get("mode", "")
    if mode in ("master", "slave"):
        stats = _distributed(workflow, mode, wants_fused()
                             if fused is None else fused)
        workflow.train_stats = stats
        return stats
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


def _distributed(workflow, mode: str, fused: bool) -> dict:
    """The master or the slave role (module docstring); the stats of
    :func:`train`, with the jobs done as ``train_steps``."""
    missing = [a for a in ("forwards", "loader", "decision")
               if getattr(workflow, a, None) is None]
    if missing:
        raise ValueError(f"--{mode} needs a StandardWorkflow-shaped graph; "
                         f"{workflow.name} lacks {missing}")
    eng = root.common.engine
    t0 = time.perf_counter()
    if mode == "master":
        from znicz_torch.server import Server

        server = Server(workflow,
                        endpoint=eng.get("master_bind", "tcp://*:5570"),
                        resume_path=eng.get("master_resume", ""))
        workflow.server = server
        server.start()
        print(f"master serving {workflow.name} at {server.endpoint}",
              flush=True)
        server.join()
        steps = server.jobs_done
        images = workflow.loader.class_samples_served[TRAIN]
    else:
        from znicz_torch.client import Client, FusedClient

        endpoint = eng.get("slave_endpoint", None)
        if not endpoint:
            raise ValueError("--slave needs the master's endpoint "
                             "(root.common.engine.slave_endpoint)")
        client = None
        if _fused_capable(workflow, fused):
            from znicz_torch.parallel.fused import FusedUnsupportedError

            try:
                client = FusedClient(workflow, endpoint=endpoint)
            except FusedUnsupportedError as exc:
                log.warning("fused slave unavailable (%s); falling back to "
                            "the unit-engine slave", exc)
        if client is None:
            if bool(eng.get("train_shard", False)):
                raise ValueError(f"{workflow.name}: a meshed slave needs the "
                                 "fused trainer (--fused)")
            client = Client(workflow, endpoint=endpoint)
        workflow.client = client
        client.run()
        steps = client.jobs_done
        images = 0
    wall = time.perf_counter() - t0
    return {"train_steps": steps, "img_per_sec": images / max(wall, 1e-9),
            "warm_img_per_sec": 0.0}


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
