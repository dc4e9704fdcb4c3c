"""Declarative model assembly (port of ``znicz_tpu/standard_workflow.py``,
without the unit graph).

Builds the forward modules from the reference's ``layers`` list::

    {"type": "conv_strict_relu", "->": {"n_kernels": 96, ...}, "<-": {...}}

``"->"`` holds the forward module's keywords; ``"<-"`` the gradient
descent hyperparameters of that layer, kept in ``workflow.gds`` (a
:class:`nn_units.GradientDescent` per weighted module, keyed by the
module's name as ``FusedTrainer.gd_of`` is).  Module ``i`` is named
``fwd_{type}_{i}``, as the reference names its units, so parameter trees
carry over by name.  Only the layer kinds AlexNet uses are ported.

For training, pass a ``loader`` (initialised here, its data put on the
workflow's device; the sample shape then defaults to the loader's), the
loss (``"softmax"``, the one ported) and the Decision's config.  A
workflow built without a loader serves only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch
from torch import nn

from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core.config import root
from znicz_torch.decision import DecisionGD
from znicz_torch.evaluator import EvaluatorSoftmax
from znicz_torch.nn_units import GradientDescent


def _registry() -> Dict[str, Type]:
    from znicz_torch import all2all, conv, dropout, lrn, pooling

    return {
        "conv_strict_relu": conv.ConvStrictRELU,
        "norm": lrn.LRNormalizerForward,
        "max_pooling": pooling.MaxPooling,
        "all2all_strict_relu": all2all.All2AllStrictRELU,
        "dropout": dropout.DropoutForward,
        "softmax": all2all.All2AllSoftmax,
    }


class StandardWorkflow(nn.Module):
    """The forward modules of a ``layers`` list, built for
    ``sample_shape`` (one sample, NHWC without the batch axis) on
    ``device``.  Parameters are random from ``generator`` (default: seeded
    from ``root.common.engine.seed``) until a trained tree is loaded
    (``weights.params_from_jax``).

    ``dtype`` is the staging dtype of requests; a uint8 input is decoded
    on the device as ``u8 * scale + shift``."""

    def __init__(self, layers: Sequence[dict],
                 sample_shape: Optional[Sequence[int]] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "StandardWorkflow", dtype=np.float32,
                 scale: float = 1.0, shift: float = 0.0, loader=None,
                 loss_function: str = "softmax",
                 decision_config: Optional[dict] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.name = name
        if loss_function != "softmax":
            raise ValueError(f"loss_function {loss_function!r}: only "
                             f"'softmax' is ported")
        self.loss_function = loss_function
        self.loader = loader
        if loader is not None:
            loader.initialize(self.device)
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
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(root.common.engine.get("seed", 1013)))
        reg = _registry()
        forwards = []
        self.gds: Dict[str, GradientDescent] = {}
        shape = (1,) + self.sample_shape
        for i, layer in enumerate(self.layers_config):
            kind = layer["type"]
            if kind not in reg:
                raise ValueError(f"unknown layer type {kind!r} "
                                 f"(known: {sorted(reg)})")
            fwd = reg[kind](name=f"fwd_{kind}_{i}", **layer.get("->", {}))
            fwd.layer_index = i
            fwd.layer_kind = kind
            shape = fwd.build(shape, generator, self.device)
            forwards.append(fwd)
            if fwd.has_weights:
                self.gds[fwd.name] = GradientDescent(fwd.name,
                                                     **layer.get("<-", {}))
        self.forwards = nn.ModuleList(forwards)
        self.output_sample_shape: Tuple[int, ...] = tuple(shape[1:])
        self.evaluator = EvaluatorSoftmax(name="evaluator")
        self.decision = DecisionGD(name="decision",
                                   **dict(decision_config or {}))
