"""The distributable payload protocol (port of
``znicz_tpu/distributable.py``).

The reference's master/slave plane asks every unit for four payloads:

    generate_data_for_slave / apply_data_from_master   (master -> slave)
    generate_data_for_master / apply_data_from_slave   (slave -> master)

:class:`Distributable` gives each forward module a default over its
parameters (weights travel master -> slave, updated weights slave ->
master) and each GD unit one over its momentum state.  A payload is a
``{name: float32 ndarray}`` dict of independent host copies: wire v3
ships each array as one zero-copy frame that may still sit in ZMQ's
queue while the next update lands on the live tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class Distributable:
    """Mixin; the default is a stateless unit (no payloads)."""

    negotiates_on_connect = False

    def _payload_tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors a payload carries: a weighted module's
        parameters."""
        from znicz_torch.nn_units import params_of

        return params_of(self) if getattr(self, "has_weights", False) \
            else {}

    def _param_arrays(self) -> Dict[str, np.ndarray]:
        return {k: t.detach().float().cpu().numpy().copy()
                for k, t in self._payload_tensors().items()}

    def _assign(self, data: Optional[dict]) -> None:
        if not data:
            return
        with torch.no_grad():
            for k, t in self._payload_tensors().items():
                if k in data:
                    t.copy_(torch.from_numpy(
                        np.array(data[k], np.float32)).to(t.device))

    # -- master side ----------------------------------------------------------

    def generate_data_for_slave(self) -> Optional[dict]:
        """Master -> slave payload: the current parameters."""
        return self._param_arrays() or None

    def apply_data_from_slave(self, data: Optional[dict]) -> None:
        """The master takes a slave's whole tensors (the reference's
        semantics; the star applies deltas instead)."""
        self._assign(data)

    # -- slave side -----------------------------------------------------------

    def apply_data_from_master(self, data: Optional[dict]) -> None:
        self._assign(data)

    def generate_data_for_master(self) -> Optional[dict]:
        """Slave -> master payload: the updated parameters."""
        return self._param_arrays() or None
