"""Learning-rate schedules (port of ``znicz_tpu/lr_adjust.py``).

Caffe-style policies over the train iteration ``t``:

  - ``fixed``     — lr(t) = base
  - ``step``      — lr(t) = base · gamma^floor(t / step)
  - ``exp``       — lr(t) = base · gamma^t
  - ``inv``       — lr(t) = base · (1 + gamma·t)^(−power)
  - ``arbitrary`` — lr(t) = fn(base, t)

:class:`LearningRateAdjust` sits in the control graph after the GD chain,
gated like the GD units, and on each run writes the scheduled rate of the
current iteration into every bound GD unit's ``learning_rate`` and
``learning_rate_bias``, then counts the iteration.  ``FusedTrainer``
steps the same unit after each update it applies, so both engines
follow one schedule; its deep pipeline rewinds the unit
(``restore_iteration``) when it rolls back.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from znicz_torch.core.units import Unit


class LRPolicyBase:
    def __call__(self, base: float, it: int) -> float:
        raise NotImplementedError


class FixedPolicy(LRPolicyBase):
    def __call__(self, base, it):
        return base


class StepPolicy(LRPolicyBase):
    def __init__(self, gamma=0.1, step=1000):
        self.gamma, self.step = float(gamma), int(step)

    def __call__(self, base, it):
        return base * self.gamma ** (it // self.step)


class ExpPolicy(LRPolicyBase):
    def __init__(self, gamma=0.999):
        self.gamma = float(gamma)

    def __call__(self, base, it):
        return base * self.gamma ** it


class InvPolicy(LRPolicyBase):
    def __init__(self, gamma=0.0001, power=0.75):
        self.gamma, self.power = float(gamma), float(power)

    def __call__(self, base, it):
        return base * (1.0 + self.gamma * it) ** (-self.power)


class ArbitraryPolicy(LRPolicyBase):
    def __init__(self, fn: Callable[[float, int], float]):
        self.fn = fn

    def __call__(self, base, it):
        return self.fn(base, it)


POLICIES = {"fixed": FixedPolicy, "step": StepPolicy, "exp": ExpPolicy,
            "inv": InvPolicy}


def make_policy(name: str, **kwargs) -> LRPolicyBase:
    return POLICIES[name](**kwargs)


class LearningRateAdjust(Unit):
    """Bind GD units with ``add_gd(gd, policy[, bias_policy])``; each
    ``run()`` (one per applied update) rewrites their rates for the
    current iteration and advances it."""

    def __init__(self, workflow=None, name: str = "lr_adjust", **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.iteration = 0
        self._bindings: List[tuple] = []

    def add_gd(self, gd, policy: LRPolicyBase,
               bias_policy: Optional[LRPolicyBase] = None) -> None:
        self._bindings.append(
            (gd, float(gd.learning_rate), float(gd.learning_rate_bias),
             policy, bias_policy or policy))

    def _apply(self, it: int) -> None:
        for gd, base, base_bias, pol, bias_pol in self._bindings:
            gd.learning_rate = pol(base, it)
            gd.learning_rate_bias = bias_pol(base_bias, it)

    def run(self):
        self._apply(self.iteration)
        self.iteration += 1

    def restore_iteration(self, iteration: int) -> None:
        """Rewind to the state right after ``iteration`` runs (the fused
        trainer's deep pipeline rolling back the epochs it speculated):
        the counter, and the bound units' rates of iteration
        ``iteration - 1``, or their bases at iteration 0."""
        self.iteration = int(iteration)
        if self.iteration > 0:
            self._apply(self.iteration - 1)
        else:
            for gd, base, base_bias, _, _ in self._bindings:
                gd.learning_rate = base
                gd.learning_rate_bias = base_bias
