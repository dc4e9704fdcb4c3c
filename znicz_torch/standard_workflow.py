"""Declarative model assembly (port of the layer-spec half of
``znicz_tpu/standard_workflow.py``).

Builds the forward modules from the reference's ``layers`` list::

    {"type": "conv_strict_relu", "->": {"n_kernels": 96, ...}, "<-": {...}}

``"->"`` holds the forward module's keywords; ``"<-"`` (the gradient
descent unit's) is kept for the training slice and ignored here.  Module
``i`` is named ``fwd_{type}_{i}``, as the reference names its units, so
parameter trees carry over by name.  Only the layer kinds AlexNet uses
are ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch
from torch import nn

from znicz_torch.backends import DeviceLike, resolve_device
from znicz_torch.core.config import root


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

    def __init__(self, layers: Sequence[dict], sample_shape: Sequence[int],
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "StandardWorkflow", dtype=np.float32,
                 scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.device = resolve_device(device)
        self.name = name
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
        self.forwards = nn.ModuleList(forwards)
        self.output_sample_shape: Tuple[int, ...] = tuple(shape[1:])

