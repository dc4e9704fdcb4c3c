"""MNIST (port of ``znicz_tpu/samples/mnist.py``, BASELINE config 0).

784 -> tanh 100 -> softmax 10, with the ``root.mnist`` defaults of the
reference entry for entry.  The data are the procedural digit glyphs of
``datasets.digits`` (or ``root.mnist.loader.data_path``'s .npz),
flattened to (N, 784) and ordered [test | valid | train].  The reference
wires its units by hand and names them ``fwd0``, ``fwd1``; the port's
modules keep those names, so the weight init draws from the same named
streams and parameter trees carry over by name.  No snapshotter runs:
the reference's interval is 0.
"""

from __future__ import annotations

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.loader.fullbatch import FullBatchLoader
from znicz_torch.samples import train
from znicz_torch.standard_workflow import StandardWorkflow

root.mnist.defaults({
    "loader": {"minibatch_size": 60, "n_train": 4000, "n_valid": 800,
               "n_test": 0, "data_path": ""},
    "layers": [100, 10],
    "learning_rate": 0.1,
    "gradient_moment": 0.9,
    "weights_decay": 0.0,
    "decision": {"max_epochs": 5, "fail_iterations": 0},
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


class MnistWorkflow(StandardWorkflow):
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
                "fail_iterations": int(cfg.decision.get("fail_iterations"))})

    def module_name(self, i: int, kind: str) -> str:
        return f"fwd{i}"


def run(device: DeviceLike = None) -> MnistWorkflow:
    """Build :class:`MnistWorkflow` on ``device`` and train it with
    ``FusedTrainer`` until the Decision completes."""
    return train(MnistWorkflow(device), "mnist")
