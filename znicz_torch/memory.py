"""Array: a host numpy buffer paired with a device tensor (port of
``znicz_tpu/memory.py``'s single-host ``Array``).

Units exchange their tensors as Arrays: the host half ``mem`` is numpy,
the device half ``devmem`` a ``torch.Tensor`` on the device the Array was
initialised on (the workflow's).  A small state machine keeps the halves
coherent:

  - ``map_read()``       makes the host half current (device -> host);
  - ``map_write()``      the same, then marks the host half newer;
  - ``map_invalidate()`` marks the host half newer without a copy;
  - ``unmap()`` / ``devmem`` make the device half current (host ->
    device when the host is newer);
  - assigning ``devmem`` adopts a computed tensor as the newer half.

The reference's cross-host sharded arrays have no counterpart: a mesh
here is a group of processes, each holding its own rows
(``parallel/mesh.py``), and a sharded snapshot agrees across the ranks
through ``mesh.raise_anywhere`` (ROADMAP, "pruned": A.7's multi-host
snapshots).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_SYNCED, _HOST_DIRTY, _DEV_DIRTY = 0, 1, 2


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class Array:
    """Host numpy buffer + lazy device tensor."""

    def __init__(self, data: Optional[np.ndarray] = None) -> None:
        self._mem: Optional[np.ndarray] = None
        self._devmem: Optional[torch.Tensor] = None
        self._state = _SYNCED
        self._device: Optional[torch.device] = None
        if data is not None:
            self.reset(data)

    def reset(self, data: Optional[np.ndarray]) -> None:
        """(Re)bind the host buffer and drop any device copy."""
        if data is not None and not isinstance(data, np.ndarray):
            data = np.asarray(data)
        self._mem = data
        self._devmem = None
        self._state = _HOST_DIRTY if data is not None else _SYNCED

    @property
    def mem(self) -> Optional[np.ndarray]:
        """The raw host buffer (no sync)."""
        return self._mem

    @mem.setter
    def mem(self, data: Optional[np.ndarray]) -> None:
        self.reset(data)

    def __bool__(self) -> bool:
        return self._mem is not None or self._devmem is not None

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._devmem is not None and self._state != _HOST_DIRTY:
            return tuple(self._devmem.shape)
        if self._mem is not None:
            return tuple(self._mem.shape)
        return ()

    @property
    def dtype(self) -> Optional[np.dtype]:
        """The numpy dtype of the current half."""
        if self._devmem is not None and self._state != _HOST_DIRTY:
            return _numpy_dtype(self._devmem)
        if self._mem is not None:
            return self._mem.dtype
        return None

    # -- the map/unmap protocol ----------------------------------------------

    def initialize(self, device) -> None:
        """Attach to ``device``; the device half is made on first use."""
        self._device = None if device is None else torch.device(device)

    def map_read(self) -> np.ndarray:
        if self._state == _DEV_DIRTY:
            self._mem = self._devmem.detach().cpu().numpy().copy()
            self._state = _SYNCED
        if self._mem is None:
            raise RuntimeError("Array.map_read on an empty Array")
        return self._mem

    def map_write(self) -> np.ndarray:
        mem = self.map_read()
        self._state = _HOST_DIRTY
        return mem

    def map_invalidate(self) -> np.ndarray:
        """The host half will be overwritten whole: no device -> host
        copy."""
        if self._mem is None and self._devmem is not None:
            self._mem = np.empty(tuple(self._devmem.shape),
                                 _numpy_dtype(self._devmem))
        if self._mem is None:
            raise RuntimeError("Array.map_invalidate on an empty Array")
        self._state = _HOST_DIRTY
        return self._mem

    def unmap(self) -> torch.Tensor:
        """Make the device half current and return it."""
        if self._state == _HOST_DIRTY or self._devmem is None:
            if self._mem is None:
                raise RuntimeError("Array.unmap on an empty Array")
            # copy=True: on the CPU the two halves must not share a buffer
            self._devmem = torch.from_numpy(np.ascontiguousarray(
                self._mem)).to(self._device or "cpu", copy=True)
            self._state = _SYNCED
        return self._devmem

    @property
    def devmem(self) -> torch.Tensor:
        """The current device tensor (host -> device first if the host is
        newer)."""
        return self.unmap()

    @devmem.setter
    def devmem(self, value: torch.Tensor) -> None:
        """Adopt a computed tensor as the newer half."""
        self._devmem = value
        self._state = _DEV_DIRTY

    def __repr__(self) -> str:
        state = {_SYNCED: "synced", _HOST_DIRTY: "host-dirty",
                 _DEV_DIRTY: "dev-dirty"}[self._state]
        return f"Array(shape={self.shape}, dtype={self.dtype}, {state})"
