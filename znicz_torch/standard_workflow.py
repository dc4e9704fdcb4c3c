"""Declarative model assembly and the training graph (port of
``znicz_tpu/standard_workflow.py``).

Builds the forward modules from the reference's ``layers`` list::

    {"type": "conv_strict_relu", "->": {"n_kernels": 96, ...}, "<-": {...}}

``"->"`` holds the forward module's keywords; ``"<-"`` the gradient
descent hyperparameters of that layer.  Module ``i`` is named
``fwd_{type}_{i}`` (:meth:`StandardWorkflowBase.module_name`), as the
reference names its units, so parameter trees carry over by name.  Every
kind of the reference's registry is ported: the fully-connected and
convolution kinds with their activations,
``resizable_all2all``, max, max-abs, average and stochastic pooling
(plain and abs), LRN, dropout, ``cutter``, the seven standalone
``activation_*`` kinds, and MnistAE's deconvolutions (plain, tanh,
sigmoid) and depooling, and ``attention`` (``attention.
MultiHeadAttention`` on a (seq, embed) sample).

``loss_function`` is ``"softmax"`` (``EvaluatorSoftmax`` on the loader's
labels, ``DecisionGD``) or ``"mse"`` (``EvaluatorMSE`` on its
``minibatch_targets``, ``DecisionMSE``).

Every module gets a forward unit (``nn_units.ForwardBase`` or its
kind's subclass) that holds it, and a GD unit ``gd_{type}_{i}``
(:meth:`StandardWorkflowBase.gd_name`).  ``forwards`` are the modules,
which ``FusedTrainer`` and the serving path run; ``forward_units`` and
``gd_units`` (chain order, last layer first) are the unit engine's;
``gds`` maps each module with weights to its GD unit, whose
hyperparameters and velocities both engines use.

With a ``loader`` (initialised here, its data put on the workflow's
device; the sample shape then defaults to the loader's) the workflow
is linked as the reference links it (:meth:`StandardWorkflow.link_graph`):

    start -> repeater -> loader -> fwd_0 .. fwd_n -> evaluator -> decision
    decision -> snapshotter -> gd_n .. gd_0 [-> lr_adjust] -> repeater

``decision.gd_skip`` gates every GD (and ``lr_adjust``),
``~decision.epoch_ended`` the snapshotter, ``~decision.complete`` the
end point; dropout and stochastic pooling units get the loader's
``minibatch_class``.  A
workflow built without a loader serves only.

The observers, as the reference wires them (:meth:`StandardWorkflow.
link_observers`): ``plotters=True`` chains ``plot_err`` (the VALID
metric an epoch: err% under softmax, the loss under MSE),
``plot_weights`` (the first weighted module's live weights, read at each
snapshot) and, under softmax, ``plot_confusion`` after the snapshotter,
each gated to epoch ends; the end point waits on the chain, and the
repeater is blocked once training completed.  ``FusedTrainer`` runs the
same plotters at its epoch ends.  ``image_saver_config`` (a dict such as
``{"limit": 32}``) links an ``image_saver.ImageSaver`` after the
evaluator of a softmax workflow (the unit engine only).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core.workflow import Repeater, Workflow
from znicz_torch.decision import DecisionGD, DecisionMSE
from znicz_torch.evaluator import EvaluatorMSE, EvaluatorSoftmax
from znicz_torch.snapshotter import Snapshotter


def _registry() -> Dict[str, Tuple[Type, Type, Type]]:
    """kind -> (module class, forward unit class, GD unit class)."""
    from znicz_torch import activation as act
    from znicz_torch import (all2all, attention, conv, cutter, deconv, depooling,
                             dropout, gd, gd_conv, gd_deconv, gd_pooling,
                             lrn, pooling, resizable_all2all)
    from znicz_torch.nn_units import ForwardBase as unit

    return {
        "all2all": (all2all.All2All, unit, gd.GradientDescent),
        "all2all_tanh": (all2all.All2AllTanh, unit, gd.GDTanh),
        "all2all_relu": (all2all.All2AllRELU, unit, gd.GDRELU),
        "all2all_strict_relu": (all2all.All2AllStrictRELU, unit,
                                gd.GDStrictRELU),
        "all2all_sigmoid": (all2all.All2AllSigmoid, unit, gd.GDSigmoid),
        "softmax": (all2all.All2AllSoftmax, unit, gd.GDSoftmax),
        "conv": (conv.Conv, unit, gd_conv.GradientDescentConv),
        "conv_tanh": (conv.ConvTanh, unit, gd_conv.GDTanhConv),
        "conv_relu": (conv.ConvRELU, unit, gd_conv.GDRELUConv),
        "conv_strict_relu": (conv.ConvStrictRELU, unit,
                             gd_conv.GDStrictRELUConv),
        "max_pooling": (pooling.MaxPooling, pooling.MaxPoolingUnit,
                        gd_pooling.GDMaxPooling),
        "maxabs_pooling": (pooling.MaxAbsPooling, pooling.MaxPoolingUnit,
                           gd_pooling.GDMaxAbsPooling),
        "avg_pooling": (pooling.AvgPooling, unit, gd_pooling.GDAvgPooling),
        "stochastic_pooling": (pooling.StochasticPooling,
                               pooling.StochasticPoolingUnit,
                               gd_pooling.GDStochasticPooling),
        "stochastic_abs_pooling": (pooling.StochasticAbsPooling,
                                   pooling.StochasticPoolingUnit,
                                   gd_pooling.GDStochasticAbsPooling),
        "norm": (lrn.LRNormalizerForward, unit, lrn.LRNormalizerBackward),
        "dropout": (dropout.DropoutForward, dropout.DropoutUnit,
                    dropout.DropoutBackward),
        "cutter": (cutter.Cutter, unit, cutter.GDCutter),
        "activation_tanh": (act.ForwardTanh, unit, act.BackwardTanh),
        "activation_sigmoid": (act.ForwardSigmoid, unit,
                               act.BackwardSigmoid),
        "activation_relu": (act.ForwardRELU, unit, act.BackwardRELU),
        "activation_str": (act.ForwardStrictRELU, unit,
                           act.BackwardStrictRELU),
        "activation_log": (act.ForwardLog, unit, act.BackwardLog),
        "activation_sincos": (act.ForwardSinCos, unit, act.BackwardSinCos),
        "activation_tanhlog": (act.ForwardTanhLog, unit,
                               act.BackwardTanhLog),
        "deconv": (deconv.Deconv, unit, gd_deconv.GDDeconv),
        "deconv_tanh": (deconv.DeconvTanh, unit, gd_deconv.GDDeconvTanh),
        "deconv_sigmoid": (deconv.DeconvSigmoid, unit,
                           gd_deconv.GDDeconvSigmoid),
        "depooling": (depooling.Depooling, unit, depooling.GDDepooling),
        "resizable_all2all": (resizable_all2all.ResizableAll2All,
                              resizable_all2all.ResizableAll2AllUnit,
                              gd.GradientDescent),
        "attention": (attention.MultiHeadAttention, unit,
                      attention.GDMultiHeadAttention),
    }


#: kinds whose train/eval behaviour follows the minibatch class
_MODE_SWITCHED = ("dropout", "stochastic_pooling",
                  "stochastic_abs_pooling")


class StandardWorkflowBase(Workflow):
    """The modules of a ``layers`` list, built for ``sample_shape`` (one
    sample, NHWC without the batch axis) on ``device``, with their units;
    :meth:`link_graph` (with a loader) wires them.  Parameters are filled
    as the reference fills them, each module from its named
    ``core.prng`` stream (seeded from ``root.common.engine.seed``), until
    a trained tree is loaded (``weights.params_from_jax``).

    ``dtype`` is the staging dtype of requests; a uint8 input is decoded
    on the device as ``u8 * scale + shift``."""

    def __init__(self, layers: Sequence[dict],
                 sample_shape: Optional[Sequence[int]] = None,
                 device: DeviceLike = None,
                 name: str = "StandardWorkflow", dtype=np.float32,
                 scale: float = 1.0, shift: float = 0.0, loader=None,
                 loss_function: str = "softmax",
                 decision_config: Optional[dict] = None,
                 snapshotter_config: Optional[dict] = None,
                 lr_adjust_config: Optional[dict] = None,
                 image_saver_config: Optional[dict] = None,
                 plotters: bool = False):
        super().__init__(name=name)
        self.device = resolve_device(device)
        if loss_function not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {loss_function!r} ('softmax' "
                             f"or 'mse')")
        self.loss_function = loss_function
        self.image_saver_config = image_saver_config
        self.want_plotters = bool(plotters)
        self.image_saver = None
        self.plotters = []
        self.loader = loader
        if loader is not None:
            self.add_unit(loader)
            loader.initialize(device=self.device)
            if sample_shape is None:
                sample_shape = loader.sample_shape
        if sample_shape is None:
            raise ValueError("a workflow without a loader needs sample_shape")
        self.layers_config: List[dict] = list(layers)
        self.sample_shape: Tuple[int, ...] = tuple(int(d)
                                                   for d in sample_shape)
        self.dtype = np.dtype(dtype)
        self.scale = float(scale)
        self.shift = float(shift)
        self.build_forwards()
        mse = loss_function == "mse"
        self.evaluator = (EvaluatorMSE if mse else EvaluatorSoftmax)(
            self, name="evaluator")
        self.decision = (DecisionMSE if mse else DecisionGD)(
            self, name="decision", **dict(decision_config or {}))
        self.snapshotter = Snapshotter(self, name="snapshotter",
                                       **dict(snapshotter_config or {}))
        self.build_gds()
        self.lr_adjust = None
        if lr_adjust_config:
            from znicz_torch.lr_adjust import LearningRateAdjust, make_policy

            cfg = dict(lr_adjust_config)
            policy = cfg.pop("policy")
            self.lr_adjust = LearningRateAdjust(self, name="lr_adjust")
            for gd in self.gd_units:
                self.lr_adjust.add_gd(gd, make_policy(policy, **cfg))
        if loader is not None:
            self.link_graph()

    def module_name(self, i: int, kind: str) -> str:
        """The name of module ``i`` of type ``kind``: the unit name under
        which the reference draws its weights and keys its trees."""
        return f"fwd_{kind}_{i}"

    def gd_name(self, i: int, kind: str) -> str:
        """The name of the GD unit of layer ``i``: its snapshot key."""
        return f"gd_{kind}_{i}"

    def build_forwards(self) -> None:
        reg = _registry()
        self.forwards = []
        self.forward_units = []
        shape = (1,) + self.sample_shape
        for i, layer in enumerate(self.layers_config):
            kind = layer["type"]
            if kind not in reg:
                raise ValueError(f"unknown layer type {kind!r} "
                                 f"(known: {sorted(reg)})")
            mod_cls, unit_cls, _ = reg[kind]
            fwd = mod_cls(name=self.module_name(i, kind),
                          **layer.get("->", {}))
            fwd.layer_index = i
            fwd.layer_kind = kind
            shape = fwd.build(shape, self.device)
            self.forwards.append(fwd)
            self.forward_units.append(unit_cls(self, module=fwd))
        self.output_sample_shape: Tuple[int, ...] = tuple(shape[1:])

    def build_gds(self) -> None:
        """GD units from the last layer to the first; the first layer's
        gives no ``err_input``."""
        reg = _registry()
        self.gd_units = []
        for i in reversed(range(len(self.forwards))):
            kind = self.forwards[i].layer_kind
            gd = reg[kind][2](self, name=self.gd_name(i, kind),
                              forward=self.forward_units[i],
                              need_err_input=(i > 0),
                              **self.layers_config[i].get("<-", {}))
            self.gd_units.append(gd)
        self.gds = {gd.forward.name: gd for gd in self.gd_units
                    if gd.forward.has_weights}

    def link_graph(self) -> None:
        raise NotImplementedError


class StandardWorkflow(StandardWorkflowBase):
    """The training graph in the reference's order of ``link_*`` steps."""

    def link_graph(self) -> None:
        self.link_repeater()
        self.link_loader()
        self.link_forwards()
        self.link_evaluator()
        self.link_decision()
        self.link_snapshotter()
        self.link_gds()
        self.link_lr_adjust()
        self.link_observers()
        self.link_loop_and_end()

    def link_repeater(self):
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)

    def link_loader(self):
        self.loader.link_from(self.repeater)

    def link_forwards(self):
        prev, prev_attr = self.loader, "minibatch_data"
        for fwd in self.forward_units:
            fwd.link_from(prev)
            fwd.link_attrs(prev, ("input", prev_attr))
            if fwd.module.layer_kind in _MODE_SWITCHED:
                fwd.link_attrs(self.loader, "minibatch_class")
            prev, prev_attr = fwd, "output"

    def link_evaluator(self):
        last = self.forward_units[-1]
        if self.loss_function == "mse":
            self.evaluator.link_attrs(self.loader,
                                      ("target", "minibatch_targets"))
        else:
            self.evaluator.link_attrs(self.loader,
                                      ("labels", "minibatch_labels"))
        self.evaluator.link_from(last)
        self.evaluator.link_attrs(last, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))

    def link_decision(self):
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch", "class_ended",
            "epoch_number", "class_lengths", "minibatch_size")
        self.decision.link_attrs(self.evaluator, ("minibatch_loss", "loss"))
        if self.loss_function == "softmax":
            self.decision.link_attrs(
                self.evaluator, ("minibatch_n_err", "n_err"),
                "confusion_matrix", "max_err_output_sum")

    def link_snapshotter(self):
        self.snapshotter.link_from(self.decision)
        self.snapshotter.link_attrs(self.decision, "epoch_number")
        self.snapshotter.improved = self.decision.improved
        self.snapshotter.gate_skip = ~self.decision.epoch_ended

    def link_gds(self):
        err_src, err_attr, tail = self.evaluator, "err_output", \
            self.snapshotter
        for gd in self.gd_units:
            gd.link_from(tail)
            gd.link_attrs(err_src, ("err_output", err_attr))
            gd.gate_skip = self.decision.gd_skip
            err_src, err_attr, tail = gd, "err_input", gd

    def link_lr_adjust(self):
        if self.lr_adjust is not None:
            self.lr_adjust.link_from(self.gd_units[-1])
            self.lr_adjust.gate_skip = self.decision.gd_skip

    def link_observers(self):
        """The optional side units: the image saver and the plotters."""
        if self.image_saver_config is not None and \
                self.loss_function == "softmax":
            from znicz_torch.image_saver import ImageSaver

            sv = ImageSaver(self, name="image_saver",
                            **self.image_saver_config)
            sv.link_from(self.evaluator)
            sv.link_attrs(self.loader, ("input", "minibatch_data"),
                          ("labels", "minibatch_labels"),
                          ("batch_size", "minibatch_size"),
                          "epoch_number", "last_minibatch")
            sv.link_attrs(self.forward_units[-1], "output")
            self.image_saver = sv
        if not self.want_plotters:
            return
        from znicz_torch.plotting_units import (AccumulatingPlotter,
                                                MatrixPlotter, Weights2D)

        dec = self.decision

        def valid_metric():
            # VALID's metrics when there is a VALID split, else TRAIN's;
            # the key follows the Decision's kind
            m = dec.epoch_metrics[1] or dec.epoch_metrics[2] or {}
            for key in ("err_pct", "mse", "loss"):
                if key in m:
                    return float(m[key])
            return 0.0

        plots = [AccumulatingPlotter(
            self, name="plot_err",
            ylabel=("valid err %" if self.loss_function == "softmax"
                    else "valid loss"),
            fetch=valid_metric)]
        first = next((u for u in self.forward_units if u.has_weights), None)
        if first is not None:
            def first_weights():
                # the live tensor at each snapshot: a trainer may replace
                # the parameter (a stored dtype, a mesh placement)
                leaves = first.params()
                return leaves.get("weights", next(iter(leaves.values())))

            plots.append(Weights2D(self, name="plot_weights",
                                   source=first_weights))
        if self.loss_function == "softmax":
            def valid_confusion():
                conf = (dec.epoch_metrics[1] or {}).get("confusion")
                return np.asarray([[0]]) if conf is None else conf

            plots.append(MatrixPlotter(self, name="plot_confusion",
                                       fetch=valid_confusion))
        prev = self.snapshotter
        for p in plots:
            p.link_from(prev)
            p.gate_skip = ~dec.epoch_ended        # at epoch ends only
            prev = p
        self.plotters = plots

    def link_loop_and_end(self):
        self.repeater.link_from(self.lr_adjust or self.gd_units[-1])
        self.end_point.link_from(self.decision)
        if self.plotters:
            # the last epoch's plots render before the run stops: the end
            # point waits on the plot chain too, so the stop lap reaches
            # the repeater first, which is blocked once training completed
            # (the loader must not advance past the end of training)
            self.end_point.link_from(self.plotters[-1])
            self.repeater.gate_block = self.decision.complete
        self.end_point.gate_block = ~self.decision.complete
