"""VideoAE (port of ``znicz_tpu/samples/video_ae.py``): an autoencoder of
video frames.

The data are the procedural moving-blob clips of
``datasets.videoframes`` (or ``root.video_ae.loader.data_path``'s .npz),
16x16 frames that are their own targets (``FullBatchLoaderMSE`` with
``targets_from_data``), ordered [test | valid | train].  ``all2all_tanh``
to a latent of 24, then a linear ``all2all`` back to the 16x16 frame,
under ``loss_function="mse"`` (``EvaluatorMSE``, ``DecisionMSE``), with
the ``root.video_ae`` defaults of the reference entry for entry.  Neither
layer reaches a kernel: on ``FusedTrainer`` (``--fused``) the step is
the two products, the MSE head and the update.
"""

from __future__ import annotations

import numpy as np

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoaderMSE
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflow

root.video_ae.defaults({
    "loader": {"minibatch_size": 100, "n_train": 2000, "n_valid": 400,
               "n_test": 0, "data_path": ""},
    "latent": 24,
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "weights_decay": 0.0,
    "decision": {"max_epochs": 20, "fail_iterations": 0},
    "snapshotter": {"prefix": "video_ae", "interval": 0},
})

#: the frames' shape, the decoder's output
FRAME_SHAPE = (16, 16)


class VideoAELoader(FullBatchLoaderMSE):
    def load_data(self):
        cfg = root.video_ae.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        n_test = int(cfg.get("n_test"))
        total = n_train + n_valid + n_test
        data, _ = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.videoframes, total)
        self.original_data = np.asarray(data, np.float32)
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


def make_layers(frame_shape=FRAME_SHAPE):
    cfg = root.video_ae
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    return [
        {"type": "all2all_tanh",
         "->": {"output_sample_shape": int(cfg.get("latent"))},
         "<-": dict(gd)},
        {"type": "all2all", "->": {"output_sample_shape": frame_shape},
         "<-": dict(gd)},
    ]


class VideoAEWorkflow(StandardWorkflow):
    """The autoencoder of ``root.video_ae`` with its loader on
    ``device``."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        cfg = root.video_ae
        super().__init__(
            make_layers(), device=device, name="VideoAEWorkflow",
            loader=VideoAELoader(
                targets_from_data=True,
                minibatch_size=int(cfg.loader.get("minibatch_size"))),
            loss_function="mse",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))},
            snapshotter_config={
                "prefix": cfg.snapshotter.get("prefix"),
                "interval": int(cfg.snapshotter.get("interval", 0))},
            **kwargs)


def run(device: DeviceLike = None, snapshot: str = "") -> VideoAEWorkflow:
    """Build :class:`VideoAEWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    (the unit graph unless ``root.common.engine.fused``)."""
    wf = VideoAEWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "video_ae")
