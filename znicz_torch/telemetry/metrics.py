"""Process-wide metrics registry (port of
``znicz_tpu/telemetry/metrics.py``).

Every service keeps its counters here, under one export surface: the
Prometheus text exposition on ``/metrics`` (``web_status.py``), while
the owning objects keep their historical attribute names as thin
properties over the registry (:func:`registered_property`).

Three metric kinds:

  - :class:`Counter` -- monotonically increasing (``inc``); settable,
    because the master's crash-resume restore writes counters back;
  - :class:`Gauge` -- a set value OR a zero-argument callable sampled at
    collect time (queue depth, the decision's epoch: no write traffic on
    the hot path);
  - :class:`Histogram` -- a fixed-size RING of observations: quantiles
    describe the most recent ``size`` samples; ``count`` and ``sum`` are
    lifetime totals.

Every series is ``znicz_<name>[_total]`` with a ``component`` label
naming the owning subsystem; a :class:`Scope` binds it.  Children are
keyed by their full label set and the LATEST registration wins, so a
rebuilt component replaces its predecessor in the export.

Threading: each metric carries its own small lock; the registry's lock
guards the family table only.  ``render_prometheus`` snapshots under
those locks and returns a string: callers write it to a socket after
the call returns, so no lock is held across a socket write.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

#: quantiles exported for histograms (Prometheus summary convention)
EXPORT_QUANTILES = (0.5, 0.9, 0.99)


def registered_property(name: str, doc: str = "") -> property:
    """The ONE home for the thin compatibility layer every migrated
    component uses: a read/write property over ``self._m[name]`` (its
    registry metric), so historical counter attribute names —
    ``srv.bad_frames``, ``client.prefetch_hits``, ... — keep working
    for web_status, resume snapshots and tests.  Writable because the
    master's crash-resume restore assigns counters back."""

    def fget(self):
        return self._m[name].value

    def fset(self, value):
        self._m[name].set(value)

    return property(fget, fset,
                    doc=doc or f"registry-backed counter {name!r}")


def weak_fn(obj, read: Callable) -> Callable[[], float]:
    """A collect-time gauge callable that does NOT pin ``obj``: the
    process-wide registry lives forever, so a gauge closing over a
    heavyweight owner (a ModelRunner's jitted executables, a workflow's
    decision) would leak the whole object graph after the owner is
    dropped.  ``read(obj)`` runs while the owner is alive; afterwards
    the gauge renders NaN (the registry's latest-wins replacement
    usually retires the series first anyway)."""
    ref = weakref.ref(obj)

    def fn():
        o = ref()
        return None if o is None else read(o)

    return fn


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _format_value(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)       # exact: never round-trip an int through float
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer():
        return str(int(f))
    return repr(f)


def _render_labels(labels: Dict[str, str], extra: Dict[str, str] = None
                   ) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``set`` exists for resume restores only."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def samples(self) -> Iterable[Tuple[Dict[str, str], float]]:
        yield {}, self._value


class Gauge:
    """Set-or-sampled value; ``fn`` (zero-arg callable) wins when given
    and is evaluated at collect time — a broken fn renders NaN instead
    of failing the whole scrape."""

    __slots__ = ("name", "help", "labels", "_value", "_fn", "_lock")

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        if self._fn is not None:
            try:
                v = self._fn()
            except Exception:
                return float("nan")
            return float("nan") if v is None else v
        return self._value

    def samples(self) -> Iterable[Tuple[Dict[str, str], float]]:
        yield {}, self.value


class Histogram:
    """Ring-buffer histogram: ``observe`` overwrites the oldest slot once
    the ring is full, so quantiles always describe the most recent
    ``size`` observations (order inside the ring is irrelevant to a
    quantile).  ``count``/``sum`` are lifetime totals.  Exported as a
    Prometheus ``summary`` (quantile children + ``_sum``/``_count``)."""

    __slots__ = ("name", "help", "labels", "_buf", "_size", "_n", "_sum",
                 "_lock")

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None, size: int = 1024):
        if size < 1:
            raise ValueError(f"histogram ring size must be >= 1, got {size}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._buf = np.zeros(int(size), np.float64)
        self._size = int(size)
        self._n = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self._buf[self._n % self._size] = v
            self._n += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def window(self) -> np.ndarray:
        """Copy of the current ring contents (the last ``min(count,
        size)`` observations, unordered)."""
        with self._lock:
            return self._buf[:min(self._n, self._size)].copy()

    def quantile(self, q: float) -> Optional[float]:
        """Quantile over the ring window; None while empty (a synthetic
        0.0 would read as a real observation)."""
        data = self.window()
        if data.size == 0:
            return None
        return float(np.quantile(data, q))

    def quantiles(self, qs: Iterable[float] = EXPORT_QUANTILES
                  ) -> Dict[float, Optional[float]]:
        data = self.window()
        if data.size == 0:
            return {float(q): None for q in qs}
        vals = np.quantile(data, list(qs))
        return {float(q): float(v) for q, v in zip(qs, vals)}

    def samples(self) -> Iterable[Tuple[Dict[str, str], float]]:
        for q, v in self.quantiles().items():
            if v is not None:
                yield {"quantile": repr(float(q))}, v


class Family:
    """All children of one metric name: one type, one help line, children
    keyed by their full label set (latest registration wins).  HELP is
    FAMILY-level, Prometheus-style: the first registrant's non-empty
    help wins, so components sharing a metric name across ``component``
    labels (master/slave ``jobs_done``) must word their help to fit
    every series (the call sites do)."""

    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: Dict[tuple, object] = {}


class Scope:
    """A label-binding view of a registry: every metric created through a
    scope carries ``component=<name>`` (plus any extra labels given per
    metric).  Creating a scope is cheap; components create one in their
    constructor."""

    __slots__ = ("_registry", "labels")

    def __init__(self, registry: "MetricsRegistry", component: str,
                 **labels):
        self._registry = registry
        self.labels = {"component": str(component), **labels}

    def _full(self, extra: Dict[str, str]) -> Dict[str, str]:
        merged = dict(self.labels)
        merged.update({k: str(v) for k, v in extra.items()})
        return merged

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        m = Counter(name, help, self._full(labels))
        self._registry._register(m)
        return m

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        m = Gauge(name, help, self._full(labels), fn=fn)
        self._registry._register(m)
        return m

    def histogram(self, name: str, help: str = "", size: int = 1024,
                  **labels) -> Histogram:
        m = Histogram(name, help, self._full(labels), size=size)
        self._registry._register(m)
        return m


class MetricsRegistry:
    """The family table + the exposition renderer.  One process-wide
    instance lives in ``znicz_torch.telemetry``; tests build their own."""

    def __init__(self, prefix: str = "znicz"):
        self.prefix = str(prefix)
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def scope(self, component: str, **labels) -> Scope:
        return Scope(self, component, **labels)

    def exported_name(self, metric) -> str:
        name = f"{self.prefix}_{metric.name}" if self.prefix else metric.name
        if metric.kind == "counter" and not name.endswith("_total"):
            name += "_total"
        return name

    def _register(self, metric) -> None:
        name = self.exported_name(metric)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, metric.kind, metric.help)
                self._families[name] = fam
            elif fam.kind != metric.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {metric.kind}")
            if not fam.help and metric.help:
                # first NON-EMPTY help wins (a helpless first registrant
                # must not permanently blank the family's # HELP line)
                fam.help = metric.help
            # latest-wins per label set: a rebuilt component replaces its
            # predecessor's child instead of leaking a stale series
            fam.children[_label_key(metric.labels)] = metric

    def collect(self) -> List[Tuple[Family, List[object]]]:
        """Snapshot of (family, children) pairs; taken under the
        structural lock, VALUES are read after it is released."""
        with self._lock:
            return [(fam, list(fam.children.values()))
                    for fam in self._families.values()]

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4).  Builds the whole body as
        a string — no registry or metric lock is held by the caller
        while it writes the result to a socket."""
        out: List[str] = []
        for fam, children in self.collect():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            # histograms export as the summary type (quantile children)
            kind = "summary" if fam.kind == "histogram" else fam.kind
            out.append(f"# TYPE {fam.name} {kind}")
            for m in children:
                if isinstance(m, Histogram):
                    for extra, v in m.samples():
                        out.append(f"{fam.name}"
                                   f"{_render_labels(m.labels, extra)} "
                                   f"{_format_value(v)}")
                    lbl = _render_labels(m.labels)
                    out.append(f"{fam.name}_sum{lbl} "
                               f"{_format_value(m.sum)}")
                    out.append(f"{fam.name}_count{lbl} "
                               f"{_format_value(m.count)}")
                else:
                    for extra, v in m.samples():
                        out.append(f"{fam.name}"
                                   f"{_render_labels(m.labels, extra)} "
                                   f"{_format_value(v)}")
        return "\n".join(out) + "\n"
