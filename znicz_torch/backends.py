"""Device resolution for the port.

Every entry point takes a ``device`` argument.  ``None`` means the card,
``cuda:0``; the CPU is used only when the caller names it
(``device="cpu"``), as the tests do.  Without a GPU and without that
argument, :func:`resolve_device` raises: nothing drops to the CPU on its
own.

Float32 parity: PyTorch runs float32 convolutions through cuDNN in TF32
by default, which keeps about three decimal digits.  The reference
computes in full float32, so resolving a device turns TF32 off for both
convolutions and matrix products.  It also restricts cuDNN to its
deterministic algorithms: some backward-filter algorithms sum in a
different order from run to run, and over a few train steps that spread
alone grew as large as the difference between two routings (PERF.md).
bf16 matrix products keep float32 sums (no reduced-precision split-K
reduction in cuBLAS), as the reference's bf16 products accumulate in
float32 and round once.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` for ``None``; the named device otherwise.  Raises when a
    CUDA device is wanted and none is available."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev

