"""Sample models of the port: ``alexnet``, ``mnist``, ``cifar``,
``mnist_ae``, ``kohonen``, ``wine``, ``kanji``, ``video_ae`` and
``yale_faces``, each with the reference sample's defaults and a
``run(device)`` that trains it as the reference's does: MNIST, CIFAR10,
Wine, Kanji, VideoAE and YaleFaces through ``engine.train`` (the unit
graph unless ``root.common.engine.fused``), AlexNet through
``FusedTrainer`` unless ``run(fused=False)``, MnistAE and Kohonen on the
unit graph, the only engine their graphs take."""

from __future__ import annotations

import logging
from typing import Optional


def train(wf, sample: str, fused: Optional[bool] = None, mesh=None):
    """Train the built workflow ``wf`` with ``engine.train`` until its
    Decision completes (``fused`` and ``mesh`` as there), log its unit
    timing and speed, and return ``wf``; the stats are kept as
    ``wf.train_stats``, the fused trainer, when it ran, as
    ``wf.trainer``."""
    from znicz_torch import engine

    stats = engine.train(wf, fused, mesh=mesh)
    wf.print_stats()
    logging.getLogger(f"znicz_torch.{sample}").info(
        "trained %d steps, %.1f images/s (%.1f warm)",
        stats["train_steps"], stats["img_per_sec"],
        stats["warm_img_per_sec"])
    return wf


def restore_snapshot(wf, path: str):
    """Resume ``wf`` from the snapshot file at ``path`` (the command
    line's ``--snapshot``); returns ``wf``."""
    from znicz_torch.snapshotter import Snapshotter, restore

    restore(wf, Snapshotter.load(path))
    return wf
