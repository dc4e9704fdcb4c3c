"""MNIST (port of ``znicz_tpu/samples/mnist.py``, BASELINE config 0).

784 -> tanh 100 -> softmax 10, with the ``root.mnist`` defaults of the
reference entry for entry.  The data are the procedural digit glyphs of
``datasets.digits`` (or ``root.mnist.loader.data_path``'s .npz),
flattened to (N, 784) and ordered [test | valid | train].  The reference
wires its units by hand and names them ``fwd0``, ``fwd1`` and ``gd1``,
``gd0``; the port keeps those names and that wiring
(:meth:`MnistWorkflow.link_graph`), so the weight init draws from the
same named streams and parameter trees and snapshots carry over by name:

    start -> repeater -> loader -> fwd0 -> fwd1 -> evaluator -> decision
    decision -> snapshotter -> gd1 -> gd0 -> repeater

The snapshotter's interval is 0, which means best-only: every epoch
whose validation error improved writes ``mnist_best.pickle.gz`` into
``root.common.dirs.snapshots``.
"""

from __future__ import annotations

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.core.workflow import Repeater
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.standard_workflow import StandardWorkflowBase

root.mnist.defaults({
    "loader": {"minibatch_size": 60, "n_train": 4000, "n_valid": 800,
               "n_test": 0, "data_path": ""},
    "layers": [100, 10],
    "learning_rate": 0.1,
    "gradient_moment": 0.9,
    "weights_decay": 0.0,
    "decision": {"max_epochs": 5, "fail_iterations": 0},
    "snapshotter": {"prefix": "mnist", "interval": 0},
})


class MnistLoader(FullBatchLoader):
    def load_data(self):
        cfg = root.mnist.loader
        n_train = int(cfg.get("n_train", 4000))
        n_valid = int(cfg.get("n_valid", 800))
        n_test = int(cfg.get("n_test", 0))
        total = n_train + n_valid + n_test
        data, labels = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.digits, total)
        self.original_data = data.reshape(total, -1)
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


def make_layers():
    """``all2all_tanh`` for every width of ``root.mnist.layers`` but the
    last, which is the softmax head."""
    cfg = root.mnist
    widths = list(cfg.get("layers"))
    gd = {"learning_rate": float(cfg.get("learning_rate")),
          "gradient_moment": float(cfg.get("gradient_moment")),
          "weights_decay": float(cfg.get("weights_decay"))}
    return [{"type": "softmax" if i == len(widths) - 1 else "all2all_tanh",
             "->": {"output_sample_shape": (int(width),)},
             "<-": dict(gd)}
            for i, width in enumerate(widths)]


class MnistWorkflow(StandardWorkflowBase):
    """The MLP of ``root.mnist`` with its loader on ``device``."""

    def __init__(self, device: DeviceLike = None):
        cfg = root.mnist
        super().__init__(
            make_layers(), device=device, name="MnistWorkflow",
            loader=MnistLoader(
                minibatch_size=int(cfg.loader.get("minibatch_size"))),
            loss_function="softmax",
            decision_config={
                "max_epochs": int(cfg.decision.get("max_epochs")),
                "fail_iterations": int(cfg.decision.get("fail_iterations"))},
            snapshotter_config={
                "prefix": cfg.snapshotter.get("prefix"),
                "interval": int(cfg.snapshotter.get("interval", 0))})

    def module_name(self, i: int, kind: str) -> str:
        return f"fwd{i}"

    def gd_name(self, i: int, kind: str) -> str:
        return f"gd{i}"

    def link_graph(self) -> None:
        """The reference's hand wiring."""
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        prev, prev_attr = self.loader, "minibatch_data"
        for fwd in self.forward_units:
            fwd.link_from(prev)
            fwd.link_attrs(prev, ("input", prev_attr))
            prev, prev_attr = fwd, "output"
        ev = self.evaluator
        ev.n_classes = int(root.mnist.get("layers")[-1])
        ev.link_from(prev)
        ev.link_attrs(prev, "output")
        ev.link_attrs(self.loader, ("labels", "minibatch_labels"),
                      ("batch_size", "minibatch_size"))
        dec = self.decision
        dec.link_from(ev)
        dec.link_attrs(self.loader, "minibatch_class", "last_minibatch",
                       "class_ended", "epoch_number", "class_lengths",
                       "minibatch_size")
        dec.link_attrs(ev, ("minibatch_loss", "loss"),
                       ("minibatch_n_err", "n_err"), "confusion_matrix",
                       "max_err_output_sum")
        snap = self.snapshotter
        snap.link_from(dec)
        snap.link_attrs(dec, "epoch_number")
        snap.improved = dec.improved
        snap.gate_skip = ~dec.epoch_ended
        err_src, err_attr, tail = ev, "err_output", snap
        for gd in self.gd_units:                 # gd1, gd0
            gd.link_from(tail)
            gd.link_attrs(err_src, ("err_output", err_attr))
            gd.gate_skip = dec.gd_skip
            err_src, err_attr, tail = gd, "err_input", gd
        self.repeater.link_from(tail)
        self.end_point.link_from(dec)
        self.end_point.gate_block = ~dec.complete


def run(device: DeviceLike = None, snapshot: str = "") -> MnistWorkflow:
    """Build :class:`MnistWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it with ``engine.train``
    until the Decision completes."""
    wf = MnistWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "mnist")
