"""MnistAE (port of ``znicz_tpu/samples/mnist_ae.py``, BASELINE config 2):
a convolutional autoencoder of the digit glyphs.

ConvTanh 9@5x5 (padding 2) -> 2x2 max pool -> depooling through the
pool's recorded offsets -> a Deconv whose weights are the convolution's
own tensor, trained against the input image (``EvaluatorMSE`` on the
loader's ``minibatch_targets``, ``DecisionMSE``), with the ``root.mnist_ae``
defaults of the reference entry for entry.  The units are wired by hand
under the reference's names, so the weight init draws from the same
named streams and parameter trees and snapshots carry over by name:

    start -> repeater -> loader -> conv -> pool -> depool -> deconv
          -> evaluator -> decision -> snapshotter
          -> gd_deconv -> gd_depool -> gd_pool -> gd_conv -> repeater

``gd_deconv`` updates the shared weights first; ``gd_conv`` then takes
its vjp at the updated weights, as the reference's does.  The graph has
no ``forwards``/``gds`` pair, so it always trains on the unit engine.
The snapshotter is best-only (``mnist_ae_best.pickle.gz``).
"""

from __future__ import annotations

from znicz_torch import datasets
from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.conv import ConvTanh
from znicz_torch.core.config import root
from znicz_torch.core.workflow import Repeater, Workflow
from znicz_torch.decision import DecisionMSE
from znicz_torch.deconv import Deconv
from znicz_torch.depooling import Depooling, GDDepooling
from znicz_torch.evaluator import EvaluatorMSE
from znicz_torch.gd_conv import GDTanhConv
from znicz_torch.gd_deconv import GDDeconv
from znicz_torch.gd_pooling import GDMaxPooling
from znicz_torch.loader.fullbatch import FullBatchLoaderMSE
from znicz_torch.nn_units import ForwardBase
from znicz_torch.pooling import MaxPooling, MaxPoolingUnit
from znicz_torch.samples import restore_snapshot, train
from znicz_torch.snapshotter import Snapshotter

root.mnist_ae.defaults({
    "loader": {"minibatch_size": 100, "n_train": 2000, "n_valid": 400,
               "n_test": 0, "data_path": ""},
    "conv": {"n_kernels": 9, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2),
             "sliding": (1, 1)},
    "pooling": {"kx": 2, "ky": 2},
    "learning_rate": 0.0003,     # MSE grads sum over pixels: a small lr
    "gradient_moment": 0.9,
    "weights_decay": 0.0,
    "decision": {"max_epochs": 5, "fail_iterations": 0},
    "snapshotter": {"prefix": "mnist_ae", "interval": 0},
})


class MnistAELoader(FullBatchLoaderMSE):
    def load_data(self):
        cfg = root.mnist_ae.loader
        n_train = int(cfg.get("n_train"))
        n_valid = int(cfg.get("n_valid"))
        n_test = int(cfg.get("n_test"))
        total = n_train + n_valid + n_test
        data, _ = datasets.load_or_generate(
            cfg.get("data_path") or None, datasets.digits, total)
        self.original_data = data[..., None]         # NHWC, C=1
        self.class_lengths = [n_test, n_valid, n_train]
        super().load_data()


class MnistAEWorkflow(Workflow):
    """The autoencoder of ``root.mnist_ae`` on ``device``; its loader is
    initialised here, and each module built at the loader's sample
    shape."""

    def __init__(self, device: DeviceLike = None):
        super().__init__(name="MnistAEWorkflow")
        self.device = dev = resolve_device(device)
        cfg = root.mnist_ae
        gd_kw = {"learning_rate": float(cfg.get("learning_rate")),
                 "gradient_moment": float(cfg.get("gradient_moment")),
                 "weights_decay": float(cfg.get("weights_decay"))}

        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)
        self.loader = MnistAELoader(
            self, name="loader", targets_from_data=True,
            minibatch_size=int(cfg.loader.get("minibatch_size")))
        self.loader.link_from(self.repeater)
        self.loader.initialize(device=dev)
        shape = (1,) + self.loader.sample_shape

        conv = ConvTanh(name="conv", **cfg.conv.to_dict())
        shape = conv.build(shape, dev)
        self.conv = ForwardBase(self, module=conv)
        self.conv.link_from(self.loader)
        self.conv.link_attrs(self.loader, ("input", "minibatch_data"))

        pool = MaxPooling(name="pool", kx=int(cfg.pooling.get("kx")),
                          ky=int(cfg.pooling.get("ky")))
        shape = pool.build(shape, dev)
        self.pool = MaxPoolingUnit(self, module=pool)
        self.pool.link_from(self.conv)
        self.pool.link_attrs(self.conv, ("input", "output"))

        depool = Depooling(name="depool", pooling_from=self.pool)
        shape = depool.build(shape, dev)
        self.depool = ForwardBase(self, module=depool)
        self.depool.link_from(self.pool)
        self.depool.link_attrs(self.pool, ("input", "output"))

        # the decoder's weights are the encoder's tensor (the reference AE)
        deconv = Deconv(name="deconv", weights_from=conv)
        deconv.output_shape_from = self.conv.input
        deconv.build(shape, dev)
        self.deconv = ForwardBase(self, module=deconv)
        self.deconv.link_from(self.depool)
        self.deconv.link_attrs(self.depool, ("input", "output"))

        self.evaluator = EvaluatorMSE(self, name="evaluator")
        self.evaluator.link_from(self.deconv)
        self.evaluator.link_attrs(self.deconv, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("target", "minibatch_targets"),
                                  ("batch_size", "minibatch_size"))

        self.decision = DecisionMSE(
            self, name="decision",
            max_epochs=int(cfg.decision.get("max_epochs")),
            fail_iterations=int(cfg.decision.get("fail_iterations")))
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch", "class_ended",
            "epoch_number", "class_lengths", "minibatch_size")
        self.decision.link_attrs(self.evaluator, ("minibatch_loss", "loss"))

        self.snapshotter = Snapshotter(
            self, name="snapshotter",
            prefix=cfg.snapshotter.get("prefix"),
            interval=int(cfg.snapshotter.get("interval", 0)))
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(self.decision, "epoch_number")
        self.snapshotter.improved = self.decision.improved
        self.snapshotter.gate_skip = ~self.decision.epoch_ended

        # the backward chain: deconv -> depool -> pool -> conv
        self.gd_deconv = GDDeconv(self, name="gd_deconv",
                                  forward=self.deconv, **gd_kw)
        self.gd_deconv.link_from(self.snapshotter)
        self.gd_deconv.link_attrs(self.evaluator, "err_output")

        self.gd_depool = GDDepooling(self, name="gd_depool",
                                     forward=self.depool)
        self.gd_depool.link_from(self.gd_deconv)
        self.gd_depool.link_attrs(self.gd_deconv,
                                  ("err_output", "err_input"))

        self.gd_pool = GDMaxPooling(self, name="gd_pool", forward=self.pool)
        self.gd_pool.link_from(self.gd_depool)
        self.gd_pool.link_attrs(self.gd_depool, ("err_output", "err_input"))

        self.gd_conv = GDTanhConv(self, name="gd_conv", forward=self.conv,
                                  need_err_input=False, **gd_kw)
        self.gd_conv.link_from(self.gd_pool)
        self.gd_conv.link_attrs(self.gd_pool, ("err_output", "err_input"))

        for gd in (self.gd_deconv, self.gd_depool, self.gd_pool,
                   self.gd_conv):
            gd.gate_skip = self.decision.gd_skip

        self.repeater.link_from(self.gd_conv)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def run(device: DeviceLike = None, snapshot: str = "") -> MnistAEWorkflow:
    """Build :class:`MnistAEWorkflow` on ``device``, resume it from
    ``snapshot`` if one is named, and train it on the unit engine until
    the Decision completes."""
    wf = MnistAEWorkflow(device)
    if snapshot:
        restore_snapshot(wf, snapshot)
    return train(wf, "mnist_ae")
