"""Kanji (port of ``znicz_tpu/samples/kanji.py``): many-class glyph
classification.

The data are the procedural stroke glyphs of ``datasets.kanji`` (or
``root.kanji.loader.data_path``'s .npz), 24x24x1 NHWC, 64 classes,
ordered [test | valid | train].  Two 3x3 ``conv_strict_relu`` layers of
16 and 32 kernels (padding 1), each followed by a 2x2 max pool, then
tanh 128 and a softmax over the classes; the ``root.kanji`` defaults
and the layer list are the reference's, entry for entry.  Under
``fused_tail`` on ``FusedTrainer`` the two convolutions take the
bias+ReLU kernels (K2 forward, K2b backward) at (B, 24, 24, 16) and
(B, 12, 12, 32); the unit engine reaches no kernel.
"""

from __future__ import annotations

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflow

root.kanji.defaults({
    "loader": {"minibatch_size": 128, "n_train": 4096, "n_valid": 512,
               "n_test": 0, "n_classes": 64, "data_path": ""},
    "learning_rate": 0.03,
    "gradient_moment": 0.9,
    "weights_decay": 0.0001,
    "decision": {"max_epochs": 8, "fail_iterations": 0},
    "snapshotter": {"prefix": "kanji", "interval": 0},
})


class KanjiLoader(FullBatchLoader):
    def load_data(self):
        cfg = root.kanji.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        n_test = int(cfg.get("n_test"))
        total = n_train + n_valid + n_test
        data, labels = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.kanji, total,
            n_classes=int(cfg.get("n_classes")))
        self.original_data = data[..., None]            # NHWC, C=1
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


def make_layers(n_classes: int):
    cfg = root.kanji
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    return [
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 32, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 128},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


class KanjiWorkflow(StandardWorkflow):
    """The convnet of ``root.kanji`` with its loader on ``device``."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        cfg = root.kanji
        super().__init__(
            make_layers(int(cfg.loader.get("n_classes"))), device=device,
            name="KanjiWorkflow",
            loader=KanjiLoader(
                minibatch_size=int(cfg.loader.get("minibatch_size"))),
            loss_function="softmax",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))},
            snapshotter_config={
                "prefix": cfg.snapshotter.get("prefix"),
                "interval": int(cfg.snapshotter.get("interval", 0))},
            **kwargs)


def run(device: DeviceLike = None, snapshot: str = "") -> KanjiWorkflow:
    """Build :class:`KanjiWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    (the unit graph unless ``root.common.engine.fused``)."""
    wf = KanjiWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "kanji")
