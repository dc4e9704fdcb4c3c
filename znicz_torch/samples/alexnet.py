"""AlexNet (port of ``znicz_tpu/samples/alexnet.py``, BASELINE config 4).

Single-tower AlexNet, 227x227x3 -> n_classes: five convolutions
(11/5/3/3/3) with LRN after conv1 and conv2, overlapping 3x3/s2 max
pools, fc6/fc7 of 4096 with dropout 0.5, and a softmax head.  The layer
list and the ``root.alexnet`` defaults are the reference's, entry for
entry.  Serving needs no loader: :class:`AlexNetWorkflow` takes the
sample shape and the class count directly.  Training builds it with
:class:`AlexNetLoader` (the reference's procedural 227x227 texture
classes, or ``root.alexnet.loader.data_path``'s .npz) through
:func:`training_workflow`; :func:`run` trains it with ``FusedTrainer``,
as the reference's ``run`` does, or with the unit engine under
``fused=False``.  Its snapshotter is best-only
(``alexnet_best.pickle.gz``).  The reference's headline configuration
trains in bf16: ``root.common.engine.compute_dtype=bf16`` (with
``state_dtype=bfloat16`` for bf16 velocities) reaches ``FusedTrainer``
through the config tree; under ``fused_elementwise`` and ``fused_tail``
its conv stack then runs the bf16 variants of K1, K1b, K2 and K2b.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import train
from znicz_torch.standard_workflow import StandardWorkflow

root.alexnet.defaults({
    "loader": {"minibatch_size": 128, "n_train": 512, "n_valid": 128,
               "n_test": 0, "n_classes": 100, "image_size": 227,
               "data_path": ""},
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "dropout": 0.5,
    "decision": {"max_epochs": 3, "fail_iterations": 0},
    "snapshotter": {"prefix": "alexnet", "interval": 0},
})


class AlexNetLoader(FullBatchLoader):
    """``n_test + n_valid + n_train`` images from ``data_path`` or the
    procedural ``tinyimages`` at ``image_size``, labels modulo
    ``n_classes``; class order [test, valid, train]."""

    def load_data(self):
        cfg = root.alexnet.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        n_test = int(cfg.get("n_test"))
        data, labels = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.tinyimages,
            n_train + n_valid + n_test, size=int(cfg.get("image_size", 227)))
        labels = (labels % int(cfg.get("n_classes", 100))).astype(np.int32)
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


def make_layers(n_classes: int):
    cfg = root.alexnet
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    drop = float(cfg.get("dropout"))
    conv1_pad = tuple(cfg.get("conv1_padding", (0, 0, 0, 0)))
    return [
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11, "sliding": (4, 4),
                "padding": conv1_pad},
         "<-": dict(gd)},
        {"type": "norm"},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
         "<-": dict(gd)},
        {"type": "norm"},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "all2all_strict_relu", "->": {"output_sample_shape": 4096},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": drop}},
        {"type": "all2all_strict_relu", "->": {"output_sample_shape": 4096},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": drop}},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


class AlexNetWorkflow(StandardWorkflow):
    """AlexNet's modules for ``sample_shape`` (default 227x227x3) and
    ``n_classes`` (default ``root.alexnet.loader.n_classes``), on
    ``device`` (``cuda:0`` unless ``"cpu"`` is asked for).  ``loader``
    and ``decision_config`` make it trainable; the other keywords
    (``plotters``, ``image_saver_config``, ``lr_adjust_config``) go to
    ``StandardWorkflow``."""

    def __init__(self, sample_shape: Optional[Sequence[int]] = (227, 227, 3),
                 n_classes: Optional[int] = None, device: DeviceLike = None,
                 loader=None, decision_config: Optional[dict] = None,
                 snapshotter_config: Optional[dict] = None, **kwargs):
        if n_classes is None:
            n_classes = int(root.alexnet.loader.get("n_classes", 100))
        super().__init__(make_layers(int(n_classes)), sample_shape,
                         device=device, name="AlexNetWorkflow", loader=loader,
                         loss_function="softmax",
                         decision_config=decision_config,
                         snapshotter_config=snapshotter_config, **kwargs)


def serving_workflow(device: DeviceLike = None) -> AlexNetWorkflow:
    """The AlexNet ``python -m znicz_torch alexnet --serve`` serves: no
    loader, its sample shape and class count from the loader config
    (``image_size``, ``n_classes``)."""
    cfg = root.alexnet.loader
    size = int(cfg.get("image_size", 227))
    return AlexNetWorkflow(sample_shape=(size, size, 3),
                           n_classes=int(cfg.get("n_classes", 100)),
                           device=device)


def training_workflow(device: DeviceLike = None,
                      **kwargs) -> AlexNetWorkflow:
    """The trainable AlexNet of the ``root.alexnet`` config: its loader
    (data resident on ``device``), sample shape and class count from the
    loader config, the Decision's ``max_epochs``/``fail_iterations`` and
    the snapshotter's ``prefix``/``interval``; ``kwargs`` go to
    :class:`AlexNetWorkflow` (``plotters=True``, ...)."""
    cfg = root.alexnet
    size = int(cfg.loader.get("image_size", 227))
    return AlexNetWorkflow(
        sample_shape=(size, size, 3),
        n_classes=int(cfg.loader.get("n_classes", 100)), device=device,
        loader=AlexNetLoader(
            minibatch_size=int(cfg.loader.get("minibatch_size"))),
        decision_config={
            "max_epochs": int(cfg.decision.get("max_epochs")),
            "fail_iterations": int(cfg.decision.get("fail_iterations"))},
        snapshotter_config={
            "prefix": cfg.snapshotter.get("prefix"),
            "interval": int(cfg.snapshotter.get("interval", 0))},
        **kwargs)


def run(device: DeviceLike = None, fused: bool = True,
        mesh=None) -> AlexNetWorkflow:
    """Build :func:`training_workflow` on ``device`` and train it until
    the Decision completes: with ``FusedTrainer`` on ``mesh`` (a
    ``parallel.mesh.make_mesh`` of this process's group; by default the
    config's training mesh), or with the unit engine when ``fused`` is
    False."""
    return train(training_workflow(device), "alexnet", fused=fused,
                 mesh=mesh)
