"""AlexNet (port of ``znicz_tpu/samples/alexnet.py``, BASELINE config 4).

Single-tower AlexNet, 227x227x3 -> n_classes: five convolutions
(11/5/3/3/3) with LRN after conv1 and conv2, overlapping 3x3/s2 max
pools, fc6/fc7 of 4096 with dropout 0.5, and a softmax head.  The layer
list is the reference's, entry for entry; serving needs no loader or
dataset, so :class:`AlexNetWorkflow` takes the sample shape and the class
count directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from znicz_torch.backends import DeviceLike
from znicz_torch.core.config import root
from znicz_torch.standard_workflow import StandardWorkflow

root.alexnet.defaults({
    "loader": {"minibatch_size": 128, "n_classes": 100, "image_size": 227},
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "dropout": 0.5,
})


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
    """AlexNet's forward modules for ``sample_shape`` (default
    227x227x3) and ``n_classes`` (default ``root.alexnet.loader.
    n_classes``), on ``device`` (``cuda:0`` unless ``"cpu"`` is asked
    for)."""

    def __init__(self, sample_shape: Sequence[int] = (227, 227, 3),
                 n_classes: Optional[int] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        if n_classes is None:
            n_classes = int(root.alexnet.loader.get("n_classes", 100))
        super().__init__(make_layers(int(n_classes)), sample_shape,
                         device=device, generator=generator,
                         name="AlexNetWorkflow")
