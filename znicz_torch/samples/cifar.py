"""CIFAR10 (port of ``znicz_tpu/samples/cifar.py``, BASELINE config 1).

Three 5x5 convolutions of 16, 32 and 32 kernels (StrictRELU, padding 2),
a 2x2 max pool and LRN after the first, 2x2 average pools after the
others, then tanh 64 and a softmax of 10; the ``root.cifar`` defaults
and the layer list are the reference's, entry for entry.  The data are
the procedural 32x32x3 textures of ``datasets.tinyimages`` (or
``root.cifar.loader.data_path``'s .npz), NHWC, ordered [test | valid |
train].  Under ``fused_tail`` the three convolutions take the bias+ReLU
kernels; under ``pallas_lrn`` the LRN takes the standalone LRN kernels.
It follows a pool, so no conv block fuses.  On the unit engine (the
default of :func:`run`) only ``pallas_lrn`` routes: the LRN units launch
K3 and K3b.  The snapshotter is best-only (``cifar_best.pickle.gz``).
"""

from __future__ import annotations

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflow

root.cifar.defaults({
    "loader": {"minibatch_size": 100, "n_train": 2000, "n_valid": 400,
               "n_test": 0, "data_path": ""},
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "weights_decay": 0.0001,
    "decision": {"max_epochs": 12, "fail_iterations": 0},
    "snapshotter": {"prefix": "cifar", "interval": 0},
})


class CifarLoader(FullBatchLoader):
    def load_data(self):
        cfg = root.cifar.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        n_test = int(cfg.get("n_test"))
        total = n_train + n_valid + n_test
        data, labels = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.tinyimages, total)
        self.original_data = data                    # NHWC
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


def make_layers():
    cfg = root.cifar
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    return [
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 16, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "norm"},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
         "<-": dict(gd)},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
         "<-": dict(gd)},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": dict(gd)},
    ]


class CifarWorkflow(StandardWorkflow):
    """The convnet of ``root.cifar`` with its loader on ``device``;
    ``kwargs`` go to ``StandardWorkflow`` (e.g. ``lr_adjust_config``)."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        cfg = root.cifar
        super().__init__(
            make_layers(), device=device, name="CifarWorkflow",
            loader=CifarLoader(
                minibatch_size=int(cfg.loader.get("minibatch_size"))),
            loss_function="softmax",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))},
            snapshotter_config={
                "prefix": cfg.snapshotter.get("prefix"),
                "interval": int(cfg.snapshotter.get("interval", 0))},
            **kwargs)


def run(device: DeviceLike = None, snapshot: str = "") -> CifarWorkflow:
    """Build :class:`CifarWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    until the Decision completes."""
    wf = CifarWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "cifar")
