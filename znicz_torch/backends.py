"""Device resolution for the port.

Every entry point takes a ``device`` argument.  ``None`` means the device
``root.common.engine.backend`` names: the card, ``cuda:0``, under "auto"
(the default), "gpu" or "cuda"; the CPU under "cpu"; "tpu" and any other
name raise ``ValueError``.  The CPU is used only when the caller names it
(``device="cpu"`` or ``backend="cpu"``), as the tests do.  Without a GPU
and without either, :func:`resolve_device` raises: "auto" never drops to
the CPU on its own.  In a process that :func:`znicz_torch.parallel.mesh.
distributed_init` joined to a group of ranks, ``None`` means that rank's
device instead (:func:`set_process_device`), unless the backend names
the CPU.

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

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


#: ``root.common.engine.backend`` -> the device ``None`` resolves to
BACKENDS = {"auto": "cuda:0", "gpu": "cuda:0", "cuda": "cuda:0",
            "cpu": "cpu"}

#: the device of this process's rank, once it joined a group
_process_device: Optional[torch.device] = None


def set_process_device(device: DeviceLike) -> None:
    """Make ``device`` the one ``None`` resolves to in this process (a
    rank's device); None forgets it."""
    global _process_device
    _process_device = None if device is None else torch.device(device)


def process_device() -> Optional[torch.device]:
    """The rank's device :func:`set_process_device` set, or None."""
    return _process_device


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device of ``root.common.engine.backend`` (:data:`BACKENDS`;
    "tpu" or any other name raises ``ValueError``), or the rank's device
    (:func:`process_device`), for ``None``; the named device otherwise.
    Raises when a CUDA device is wanted and none is available."""
    from znicz_torch.core.config import root

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    if device is None:
        backend = str(root.common.engine.get("backend", "auto"))
        if backend not in BACKENDS:
            raise ValueError(
                f"root.common.engine.backend={backend!r}: the port runs on "
                f"{sorted(BACKENDS)} ('tpu' has no meaning under PyTorch)")
        device = BACKENDS[backend]
        if backend != "cpu" and _process_device is not None:
            device = _process_device
    dev = torch.device(device)
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

