"""Sample models of the port: ``alexnet``, ``mnist`` and ``cifar``, each
with the reference sample's defaults and a ``run(device)`` that trains
it with ``FusedTrainer``."""

from __future__ import annotations

import logging


def train(wf, sample: str):
    """Train the built workflow ``wf`` with ``FusedTrainer`` until its
    Decision completes; the trainer is kept as ``wf.trainer``.  Returns
    ``wf``."""
    from znicz_torch.parallel.fused import FusedTrainer

    trainer = FusedTrainer(wf)
    trainer.run()
    wf.trainer = trainer
    logging.getLogger(f"znicz_torch.{sample}").info(
        "trained %d steps, %.1f images/s (%.1f after the first step)",
        trainer.stats["train_steps"], trainer.stats["img_per_sec"],
        trainer.stats["warm_img_per_sec"])
    return wf
