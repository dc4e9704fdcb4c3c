"""Unit: the node of the dataflow graph (the port's own copy of
``znicz_tpu/core/units.py``; its logging mixin is ``core/logger.py``'s).

  - control edges by ``link_from``: a unit fires once every unit it is
    linked from has fired in the current wave;
  - data edges by ``link_attrs``: reads of a linked attribute resolve to
    the source unit's attribute at access time (aliasing, not copying);
  - ``gate_block`` (do not run, do not propagate) and ``gate_skip`` (do
    not run, but propagate), each a :class:`~znicz_torch.core.mutable.Bool`;
  - ``initialize()`` then ``run()``; ``run_count`` and ``run_time`` (host
    seconds) are kept by ``Workflow.run``.

Execution is the deterministic single-threaded wave of
``core.workflow.Workflow.run``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

from znicz_torch.core.logger import Logger
from znicz_torch.core.mutable import Bool, LinkableAttribute

AttrLink = Union[str, Tuple[str, str]]


class Unit(Logger):
    """A node of the workflow graph."""

    #: fire when ANY control predecessor fired (``Repeater``), not all
    gate_any = False

    def __init__(self, workflow: Optional["Unit"] = None,
                 name: Optional[str] = None, **kwargs) -> None:
        # the link table must exist before __setattr__ is first used
        object.__setattr__(self, "_linked_attrs", {})
        self.name = name or type(self).__name__
        self.workflow = None
        self.links_from: Dict["Unit", bool] = {}   # unit -> fired this wave
        self.links_to: List["Unit"] = []
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._initialized = False
        self.run_count = 0
        self.run_time = 0.0                         # host seconds
        if workflow is not None:
            workflow.add_unit(self)

    # -- attribute linking ---------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        # called only when normal lookup fails: consult the links
        link = object.__getattribute__(self, "_linked_attrs").get(name)
        if link is not None:
            return link.get()
        raise AttributeError(
            f"{type(self).__name__} {self.__dict__.get('name', '?')!r} has "
            f"no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        links = object.__getattribute__(self, "_linked_attrs")
        link = links.get(name)
        if link is not None and link.two_way:
            link.set(value)
            return
        if link is not None:
            # writing a one-way linked attribute detaches the link
            del links[name]
        object.__setattr__(self, name, value)

    def link_attrs(self, other: "Unit", *attrs: AttrLink,
                   two_way: bool = False) -> "Unit":
        """Data edges.  Each attr is ``"name"`` (the same name on both
        sides) or ``("mine", "theirs")``."""
        for attr in attrs:
            mine, theirs = (attr, attr) if isinstance(attr, str) else attr
            if mine in self.__dict__:       # an attribute would shadow it
                object.__delattr__(self, mine)
            self._linked_attrs[mine] = LinkableAttribute(other, theirs,
                                                         two_way=two_way)
        return self

    def has_linked_attr(self, name: str) -> bool:
        return name in self._linked_attrs

    # -- control linking -----------------------------------------------------

    def link_from(self, *units: "Unit") -> "Unit":
        for unit in units:
            if unit is self:
                raise ValueError(f"{self.name}: cannot link from itself")
            self.links_from[unit] = False
            if self not in unit.links_to:
                unit.links_to.append(self)
        return self

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, **kwargs) -> None:
        """Allocate state; the owning workflow calls it once before
        running.  Subclasses call ``super().initialize(**kwargs)``."""
        self._initialized = True

    def run(self) -> None:
        """One firing.  Subclasses override."""

    def stop(self) -> None:
        """Called when the workflow stops."""

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    def reset_links(self) -> None:
        for unit in self.links_from:
            self.links_from[unit] = False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TrivialUnit(Unit):
    """A unit with no compute: control-graph plumbing."""
