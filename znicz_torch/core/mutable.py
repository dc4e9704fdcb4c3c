"""Linkable mutable booleans, the control flow of the unit graph (the
port's own copy of ``znicz_tpu/core/mutable.py``).

A :class:`Bool` is a mutable cell whose truth value can change over time.
``~a``, ``a & b`` and ``a | b`` build live expressions over their
sources, evaluated each time they are read, so a gate wired once to
``~decision.complete`` follows it for the whole run.  Units' gates and
the Decision's ``complete``/``improved``/``epoch_ended``/``gd_skip`` are
Bools.
"""

from __future__ import annotations

from typing import Callable, Optional


class Bool:
    """A mutable boolean cell, composable by reference.

    A derived Bool (from ``~``, ``&``, ``|``) recomputes from its sources
    on every truth test.  ``set`` stores a concrete value and detaches
    any expression."""

    __slots__ = ("_value", "_compute")

    def __init__(self, value: bool = False) -> None:
        self._value = bool(value)
        self._compute: Optional[Callable[[], bool]] = None

    def __bool__(self) -> bool:
        if self._compute is not None:
            return self._compute()
        return self._value

    @property
    def derived(self) -> bool:
        """True for a live expression over other Bools."""
        return self._compute is not None

    def set(self, value: bool) -> None:
        """Store a concrete value (detaches any expression)."""
        self._compute = None
        self._value = bool(value)

    @classmethod
    def _derived(cls, compute: Callable[[], bool]) -> "Bool":
        b = cls()
        b._compute = compute
        return b

    def __invert__(self) -> "Bool":
        return Bool._derived(lambda: not bool(self))

    def __and__(self, other) -> "Bool":
        return Bool._derived(lambda: bool(self) and bool(other))

    def __or__(self, other) -> "Bool":
        return Bool._derived(lambda: bool(self) or bool(other))

    def __repr__(self) -> str:
        kind = "derived" if self._compute is not None else "plain"
        return f"Bool({bool(self)}, {kind})"


class LinkableAttribute:
    """The record of one ``Unit.link_attrs`` data edge: reads of the linked
    name resolve to ``getattr(obj, name)`` at access time, so rebinding
    the source attribute is seen downstream; a two-way link also forwards
    writes."""

    __slots__ = ("obj", "name", "two_way")

    def __init__(self, obj, name: str, two_way: bool = False) -> None:
        self.obj = obj
        self.name = name
        self.two_way = two_way

    def get(self):
        return getattr(self.obj, self.name)

    def set(self, value) -> None:
        setattr(self.obj, self.name, value)

    def __repr__(self) -> str:
        arrow = "<->" if self.two_way else "->"
        return f"Link({arrow} {type(self.obj).__name__}.{self.name})"
