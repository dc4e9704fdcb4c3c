"""The accelerated-unit layer (port of ``znicz_tpu/accelerated_units.py``).

The reference's per-backend method dispatch and kernel-source assembly
have no counterpart here: a unit's compute is its module's PyTorch
forward, and the CUDA kernels are built by ``_build``.  What remains:

  - ``AcceleratedUnit``, ``AcceleratedGDUnit`` and ``AcceleratedWorkflow``,
    the reference-era names of the unit and workflow bases;
  - :class:`DeviceBenchmark` — times the reference's representative step
    (a matmul and tanh forward, its backward and an SGD update at
    ``size`` x ``size``) on each torch device present, ``cuda:0`` where
    there is one and ``cpu``, and names the fastest.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from znicz_torch.core.workflow import Workflow
from znicz_torch.nn_units import ForwardBase, GradientDescentBase

#: reference-era names for the same layers
AcceleratedUnit = ForwardBase
AcceleratedGDUnit = GradientDescentBase
AcceleratedWorkflow = Workflow


class DeviceBenchmark:
    """Seconds of one step on each device (``results``, keyed "cuda" and
    "cpu"); ``best()`` is the fastest device's name.  A CUDA step is timed
    with CUDA events around ``repeats`` steps, a CPU step with the host
    clock."""

    def __init__(self, size: int = 1024, repeats: int = 5):
        self.size = int(size)
        self.repeats = int(repeats)
        self.results: Dict[str, float] = {}

    def devices(self) -> Dict[str, torch.device]:
        out = {"cpu": torch.device("cpu")}
        if torch.cuda.is_available():
            out["cuda"] = torch.device("cuda", 0)
        return out

    def _step_time(self, device: torch.device) -> float:
        n = self.size
        x = torch.ones((n, n), dtype=torch.float32, device=device)
        w = torch.from_numpy(np.random.default_rng(0).normal(
            0, 0.01, (n, n)).astype(np.float32)).to(device)

        def step(w):
            w = w.detach().requires_grad_(True)
            g, = torch.autograd.grad(torch.sum(torch.tanh(x @ w)), w)
            return (w - 0.01 * g).detach()

        w = step(w)                             # warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(self.repeats):
                w = step(w)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.repeats
        t0 = time.perf_counter()
        for _ in range(self.repeats):
            w = step(w)
        return (time.perf_counter() - t0) / self.repeats

    def run(self) -> Dict[str, float]:
        for name, dev in self.devices().items():
            self.results[name] = self._step_time(dev)
        return self.results

    def best(self) -> Optional[str]:
        if not self.results:
            self.run()
        if not self.results:
            return None
        return min(self.results, key=self.results.get)
