"""Workflow: a container unit with a run loop (the port's own copy of
``znicz_tpu/core/workflow.py``).

``StartPoint`` fires first; a unit fires when all its control
predecessors fired in the wave, a ``Repeater`` when any did (it closes
the training loop); ``EndPoint`` stops the workflow.  The loop is a
deterministic single-threaded queue.  Each unit firing is a ``unit``
span named after the unit (its timing reused: no extra clock reads).
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

from znicz_torch import telemetry
from znicz_torch.core.mutable import Bool
from znicz_torch.core.units import TrivialUnit, Unit


class StartPoint(TrivialUnit):
    pass


class EndPoint(TrivialUnit):
    def run(self) -> None:
        self.workflow.stopped.set(True)


class Repeater(TrivialUnit):
    """Loop-closing unit: fires when ANY predecessor fired, so the start
    point and the tail of the GD chain can both feed it."""

    gate_any = True


class Workflow(Unit):
    """A unit that owns a set of units and runs their control graph."""

    def __init__(self, workflow: Optional[Unit] = None,
                 name: Optional[str] = None, **kwargs) -> None:
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.units: List[Unit] = []
        self.start_point = StartPoint(name="start_point")
        self.end_point = EndPoint(name="end_point")
        self.add_unit(self.start_point)
        self.add_unit(self.end_point)
        self.stopped = Bool(False)
        self.device = None

    # -- membership ----------------------------------------------------------

    def add_unit(self, unit: Unit) -> None:
        """Adopt ``unit``; a name already taken gets ``_2``, ``_3``, ...
        (snapshots key units by name)."""
        if unit not in self.units:
            taken = {u.name for u in self.units}
            if unit.name in taken:
                i = 2
                while f"{unit.name}_{i}" in taken:
                    i += 1
                unit.name = f"{unit.name}_{i}"
            self.units.append(unit)
            unit.workflow = self

    def __iter__(self):
        return iter(self.units)

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, device=None, **kwargs) -> None:
        """Initialise every unit not initialised yet, on ``device`` (the
        workflow's own when None).  A unit whose initialize raises
        ``AttributeError`` (a link not resolvable yet) is retried once
        after the rest; a second failure is raised, chained to the
        first."""
        super().initialize(**kwargs)
        if device is not None:
            self.device = device
        pending = [u for u in self.units if not u.is_initialized]
        retry: List[tuple] = []
        for unit in pending:
            try:
                unit.initialize(device=self.device, **kwargs)
            except AttributeError as exc:
                retry.append((unit, exc))
        for unit, first_exc in retry:
            try:
                unit.initialize(device=self.device, **kwargs)
            except Exception as exc:
                raise exc from first_exc

    def run(self) -> None:
        """Run the control graph until EndPoint fires (or nothing is
        ready)."""
        if not self.is_initialized:
            self.initialize()
        self.stopped.set(False)
        for unit in self.units:
            unit.reset_links()
        tracer = telemetry.tracer()
        started_run = time.perf_counter()
        queue: deque = deque([self.start_point])
        queued = {self.start_point}
        while queue and not self.stopped:
            unit = queue.popleft()
            queued.discard(unit)
            if bool(unit.gate_block):
                continue
            if not bool(unit.gate_skip):
                started = time.perf_counter()
                unit.run()
                elapsed = time.perf_counter() - started
                unit.run_time += elapsed
                unit.run_count += 1
                if tracer.enabled:
                    tracer.add("unit", unit.name, started, elapsed)
            for target in unit.links_to:
                target.links_from[unit] = True
                fire = (any(target.links_from.values()) if target.gate_any
                        else all(target.links_from.values()))
                if fire and target not in queued:
                    # a gate_any unit fed by two units that fire in the
                    # same wave still runs once per wave
                    target.reset_links()
                    queue.append(target)
                    queued.add(target)
        self.run_time += time.perf_counter() - started_run

    def stop(self) -> None:
        self.stopped.set(True)
        for unit in self.units:
            if unit is not self:
                unit.stop()

    # -- observability -------------------------------------------------------

    def print_stats(self) -> str:
        """Per-unit host-time table, logged and returned."""
        total = sum(u.run_time for u in self.units) or 1e-12
        lines = [f"{'unit':<32}{'runs':>8}{'time_s':>12}{'%':>8}"]
        for u in sorted(self.units, key=lambda u: -u.run_time):
            if u.run_count:
                lines.append(f"{u.name:<32}{u.run_count:>8}"
                             f"{u.run_time:>12.4f}"
                             f"{100.0 * u.run_time / total:>8.1f}")
        table = "\n".join(lines)
        self.info("unit timing:\n%s", table)
        return table

    def generate_graph(self) -> str:
        """Graphviz dot text of the control graph."""
        lines = ["digraph workflow {", "  rankdir=TB;"]
        for unit in self.units:
            lines.append(f'  "{unit.name}" [shape=box];')
        for unit in self.units:
            for target in unit.links_to:
                lines.append(f'  "{unit.name}" -> "{target.name}";')
        lines.append("}")
        return "\n".join(lines)
