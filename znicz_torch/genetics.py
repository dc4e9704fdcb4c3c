"""Genetic hyperparameter search (port of ``znicz_tpu/genetics.py``).

Numeric config leaves are marked tunable with :class:`Tune` ranges::

    root.mnist.learning_rate = Tune(0.1, 0.01, 1.0)

and :class:`GeneticsOptimizer` evolves real-valued chromosomes over them
(tournament selection, blend crossover, gaussian mutation, elitism): it
writes each individual's values into the config tree and scores it with
``evaluate() -> fitness`` (lower is better: the final validation error).
Its draws come from the ``genetics`` stream of ``core.prng``, a numpy
generator seeded as the reference's, so for one seed and one fitness
function both packages draw the same chromosomes.

Evaluation runs in this process (``evaluate``), or each individual is a
run of its own: ``subprocess_evaluator=SubprocessEvaluator(...)`` with
``workers=N`` launches ``python -m znicz_torch <sample> root.x=...
--fitness`` for up to N individuals at a time, each in its own process
with its own device and config, and reads the fitness from the run's
``{"genetics_fitness": x}`` line.  On one card keep N small: the
processes share it.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from znicz_torch.core import prng
from znicz_torch.core.config import Config


class Tune:
    """A tunable numeric config leaf."""

    def __init__(self, default, minimum, maximum):
        self.default = float(default)
        self.min = float(minimum)
        self.max = float(maximum)

    def __float__(self):
        return self.default

    def __repr__(self):
        return f"Tune({self.default}, [{self.min}, {self.max}])"


def find_tunes(cfg: Config, prefix: str = "") -> List[Tuple[str, Tune]]:
    """(dotted path, Tune) of every Tune leaf under ``cfg``, in the
    tree's order."""
    out = []
    for key, value in cfg.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Tune):
            out.append((path, value))
        elif isinstance(value, Config):
            out.extend(find_tunes(value, path))
    return out


class SubprocessEvaluator:
    """Scores one chromosome as a run of ``python -m znicz_torch
    <workflow>`` with the chromosome as dotted overrides (``prefix``
    maps the optimizer's paths onto the global tree, e.g.
    ``"root.mnist"``) and ``--fitness``; ``overrides`` are passed before
    them (flags too, such as ``--device cpu``).  ``cwd`` defaults to the
    directory that holds the ``znicz_torch`` package; a run has
    ``timeout`` seconds from its launch."""

    def __init__(self, workflow: str, overrides: Sequence[str] = (),
                 prefix: str = "root",
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None, timeout: float = 3600.0):
        self.workflow = workflow
        self.overrides = list(overrides)
        self.prefix = prefix.rstrip(".")
        self.env = env
        if cwd is None:
            import znicz_torch

            cwd = os.path.dirname(os.path.dirname(
                os.path.abspath(znicz_torch.__file__)))
        self.cwd = cwd
        self.timeout = float(timeout)

    def command(self, assignments: Dict[str, float]) -> List[str]:
        return ([sys.executable, "-m", "znicz_torch", self.workflow]
                + self.overrides
                + [f"{self.prefix}.{path}={value!r}"
                   for path, value in assignments.items()]
                + ["--fitness"])

    def launch(self, assignments: Dict[str, float]) -> subprocess.Popen:
        env = dict(os.environ, **self.env) if self.env else None
        proc = subprocess.Popen(self.command(assignments), env=env,
                                cwd=self.cwd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        # the budget runs from the launch: a batch of hung individuals
        # clears in about one timeout, not workers times it
        proc.deadline = time.monotonic() + self.timeout
        return proc

    def fitness_from(self, proc: subprocess.Popen) -> float:
        left = getattr(proc, "deadline",
                       time.monotonic() + self.timeout) - time.monotonic()
        try:
            stdout, stderr = proc.communicate(timeout=max(0.0, left))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(
                f"genetics individual timed out after {self.timeout}s")
        if proc.returncode:
            raise RuntimeError(
                f"genetics individual failed (rc={proc.returncode}):\n"
                f"{stderr[-2000:]}")
        for line in reversed(stdout.strip().splitlines()):
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict) and "genetics_fitness" in record:
                return float(record["genetics_fitness"])
        raise RuntimeError("the run printed no genetics_fitness line")


class GeneticsOptimizer:
    """The reference's GA, operator for operator and draw for draw, over
    the Tune leaves of ``config_root``: ``run()`` returns (best
    chromosome, its fitness) and leaves the config at the winner;
    ``history`` is each generation's best fitness."""

    def __init__(self, evaluate: Optional[Callable[[], float]] = None,
                 config_root: Config = None,
                 generations: int = 5, population: int = 8,
                 mutation_rate: float = 0.25, elite: int = 1,
                 workers: int = 1,
                 subprocess_evaluator: Optional[SubprocessEvaluator] = None):
        if evaluate is None and subprocess_evaluator is None:
            raise ValueError("need evaluate() or a subprocess_evaluator")
        if config_root is None:
            raise ValueError("config_root (the Config subtree holding the "
                             "Tune leaves) is required")
        self.evaluate = evaluate
        self.config_root = config_root
        self.workers = max(1, int(workers))
        self.subprocess_evaluator = subprocess_evaluator
        self.max_parallel = 0              # observed batch width (tests)
        self.tunes = find_tunes(config_root)
        if not self.tunes:
            raise ValueError("no Tune leaves found under the config root")
        self.generations = int(generations)
        self.population_size = int(population)
        self.mutation_rate = float(mutation_rate)
        self.elite = int(elite)
        self.rng = prng.get("genetics").state
        self.best_chromo = None
        self.best_fitness = np.inf
        self.history: List[float] = []

    # -- chromosome plumbing ---------------------------------------------------

    def _random_chromo(self) -> np.ndarray:
        return np.array([self.rng.uniform(t.min, t.max)
                         for _, t in self.tunes])

    def _default_chromo(self) -> np.ndarray:
        return np.array([t.default for _, t in self.tunes])

    def _apply(self, chromo: np.ndarray) -> None:
        for (path, tune), val in zip(self.tunes, chromo):
            self.config_root.set_by_path(path, float(val))

    def _fitness(self, chromo: np.ndarray) -> float:
        self._apply(chromo)
        return float(self.evaluate())

    def _assignments(self, chromo: np.ndarray) -> Dict[str, float]:
        return {path: float(v) for (path, _), v in zip(self.tunes, chromo)}

    def _score_population(self, pop):
        """Fill in missing fitnesses: in this process one by one, or in
        batches of up to ``workers`` concurrent runs."""
        pending = [(i, c) for i, (c, f) in enumerate(pop) if f is None]
        fits: Dict[int, float] = {}
        evaluator = self.subprocess_evaluator
        if evaluator is not None:
            log = logging.getLogger("genetics")
            for start in range(0, len(pending), self.workers):
                batch = pending[start:start + self.workers]
                procs = []
                try:
                    # launch INSIDE the try: a failed launch mid-batch must
                    # still reap the already-started siblings
                    for i, c in batch:
                        procs.append((i, evaluator.launch(
                            self._assignments(c))))
                    self.max_parallel = max(self.max_parallel, len(procs))
                    for i, proc in procs:
                        try:
                            fits[i] = evaluator.fitness_from(proc)
                        except RuntimeError as exc:
                            # one bad individual must not abort the GA (or
                            # leak its batch): penalize and move on
                            log.warning("individual %d failed: %s", i, exc)
                            fits[i] = float("inf")
                finally:
                    for _, proc in procs:       # hard-failure path cleanup
                        if proc.poll() is None:
                            proc.kill()
                            proc.communicate()
        else:
            for i, c in pending:
                fits[i] = self._fitness(c)
        return [(c, fits[i] if f is None else f)
                for i, (c, f) in enumerate(pop)]

    # -- GA operators ----------------------------------------------------------

    def _tournament(self, scored) -> np.ndarray:
        k = min(3, len(scored))
        picks = self.rng.choice(len(scored), size=k, replace=False)
        best = min(picks, key=lambda i: scored[i][1])
        return scored[best][0]

    def _crossover(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        alpha = self.rng.uniform(0.0, 1.0, size=a.shape)
        return alpha * a + (1.0 - alpha) * b

    def _mutate(self, c: np.ndarray) -> np.ndarray:
        c = c.copy()
        for i, (_, t) in enumerate(self.tunes):
            if self.rng.random() < self.mutation_rate:
                span = t.max - t.min
                c[i] = np.clip(c[i] + self.rng.normal(0, 0.15 * span),
                               t.min, t.max)
        return c

    # -- main loop -------------------------------------------------------------

    def run(self) -> Tuple[np.ndarray, float]:
        # population entries are (chromo, fitness|None); elites carry their
        # fitness forward so a full workflow run is never repeated for an
        # unchanged chromosome
        pop = [(self._default_chromo(), None)]
        while len(pop) < self.population_size:
            pop.append((self._random_chromo(), None))
        for gen in range(self.generations):
            scored = self._score_population(pop)
            scored.sort(key=lambda cf: cf[1])
            if scored[0][1] < self.best_fitness:
                self.best_fitness = scored[0][1]
                self.best_chromo = scored[0][0].copy()
            self.history.append(scored[0][1])
            nxt = [(c.copy(), f) for c, f in scored[:self.elite]]
            while len(nxt) < self.population_size:
                child = self._crossover(self._tournament(scored),
                                        self._tournament(scored))
                nxt.append((self._mutate(child), None))
            pop = nxt
        if self.best_chromo is None:      # every individual was penalized
            raise RuntimeError("genetics: every individual failed; see the "
                               "'genetics' logger for per-run errors")
        self._apply(self.best_chromo)     # leave config at the winner
        return self.best_chromo, self.best_fitness
