"""Global dotted config tree — the port's own copy of
``znicz_tpu/core/config.py`` (``Config``, ``root``, ``apply_overrides``).

A global attribute tree ``root`` that sample configs mutate
(``root.alexnet.dropout = 0.5``) and that dotted ``key.path=value``
overrides reach.  The port's tree is a separate object from the
reference's: a knob set on one is not seen by the other.
"""

from __future__ import annotations

import ast
import sys
from typing import Any, Dict, Iterator, Tuple


class Config:
    """An attribute tree node.  Accessing an unknown attribute creates a
    child ``Config``, so configs can be assigned deeply without
    pre-declaration::

        root.alexnet.loader.minibatch_size = 60
    """

    def __init__(self, path: str = "") -> None:
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_children", {})

    # -- tree access ---------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        children = object.__getattribute__(self, "_children")
        if name not in children:
            children[name] = Config(self._join(name))
        return children[name]

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if isinstance(value, dict):
            node = Config(self._join(name))
            node.update(value)
            value = node
        self._children[name] = value

    def __delattr__(self, name: str) -> None:
        self._children.pop(name, None)

    def _join(self, name: str) -> str:
        return f"{self._path}.{name}" if self._path else name

    # -- dict-ish API --------------------------------------------------------

    def update(self, values: Dict[str, Any]) -> "Config":
        """Recursively merge a plain dict into this subtree."""
        for key, value in values.items():
            if isinstance(value, dict):
                child = getattr(self, key)
                if not isinstance(child, Config):
                    child = Config(self._join(key))
                    self._children[key] = child
                child.update(value)
            else:
                setattr(self, key, value)
        return self

    def defaults(self, values: Dict[str, Any]) -> "Config":
        """Like update(), but existing leaves win — sample modules use this
        so user overrides set before import are not clobbered."""
        for key, value in values.items():
            existing = self._children.get(key)
            # an empty node is what a mere read autovivifies: absent
            is_vacant = (existing is None or
                         (isinstance(existing, Config) and not existing))
            if isinstance(value, dict):
                if existing is not None and isinstance(existing, Config):
                    existing.defaults(value)
                elif is_vacant:
                    setattr(self, key, value)
            elif is_vacant:
                setattr(self, key, value)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        """A leaf value, or ``default`` if absent or still a bare node."""
        value = self._children.get(name, default)
        if isinstance(value, Config) and not value._children:
            return default
        return value

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._children.items())

    def __contains__(self, name: str) -> bool:
        return name in self._children

    def __bool__(self) -> bool:
        return bool(self._children)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self._children.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    def __repr__(self) -> str:
        return f"Config({self._path!r}: {self.to_dict()!r})"

    # -- dotted-path access (overrides) --------------------------------------

    def set_by_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            node = getattr(node, part)
            if not isinstance(node, Config):
                raise KeyError(f"{dotted}: {part} is a leaf, not a subtree")
        setattr(node, parts[-1], value)

    def get_by_path(self, dotted: str, default: Any = None) -> Any:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if not isinstance(node, Config):
                return default
            node = node._children.get(part)
        if not isinstance(node, Config):
            return default
        return node.get(parts[-1], default)


def parse_override(arg: str) -> Tuple[str, Any]:
    """Parse one override ``a.b.c=value``; value via literal_eval with a
    string fallback."""
    if "=" not in arg:
        raise ValueError(f"override must look like key.path=value, got {arg!r}")
    key, raw = arg.split("=", 1)
    key = key.strip()
    if key.startswith("root."):
        key = key[len("root."):]
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    return key, value


def apply_overrides(cfg: "Config", args: list[str]) -> None:
    for arg in args:
        key, value = parse_override(arg)
        cfg.set_by_path(key, value)


#: The port's global config tree.
root = Config("root")

root.common.engine.seed = 1013
root.common.dirs.snapshots = "snapshots"

#: Every ``root.common.engine.*`` knob the port reads, with the reference's
#: names and documented defaults (the read sites keep their own defaults;
#: this table declares, it does not apply).
ENGINE_DEFAULTS = {
    "seed": 1013,
    "precision": "float32",       # legacy alias of compute_dtype
    "compute_dtype": None,        # "float32" | "bf16"/"bfloat16"
    "master_dtype": "float32",    # bf16-stored parameters (FusedTrainer)
    "state_dtype": "float32",     # velocity storage ("bfloat16")
    "fused_elementwise": False,   # conv1/conv2 block kernel (K1)
    "fused_tail": False,          # conv3-5 bias+ReLU kernel (K2), FC epilogue
    "lrn_pow": False,             # plain pow instead of the rsqrt form
    "lrn_autodiff": False,        # shifted-slices LRN formulation
    "pallas_lrn": False,          # standalone LRN kernel (K3)
    "fused": False,               # FusedTrainer instead of the unit engine
    "pool_bwd": "sas",            # "mask": ties share a max pool's gradient
    "snapshot_min_interval_s": 0.0,   # least seconds between best saves
    "native_shuffle": False,      # the host runtime's xorshift128+ shuffle
    # the segmented run (FusedTrainer) and the streaming data path
    "remat": False,               # recompute the forward in the backward
    "scan_chunk": 8,              # train/eval steps a segment; 1 = no scan
    "async_snapshot": True,       # snapshots written by a background thread
    "prefetch_segments": 2,       # segments of rows decoded ahead
    "decode_workers": None,       # DecodePool threads (None: one a CPU)
    "stream_budget_mb": None,     # device budget of a StreamingLoader
    "async_staging": True,        # DeviceStager assembles segments ahead
    "staging_donate": True,       # consumed staged buffers go back to it
    # the deep pipeline (FusedTrainer) and the compiler knobs
    "pipeline_depth": 1,          # epochs queued before their metrics are read
    "backend": "auto",            # device None: the card, or "cpu"
    "fuse": True,                 # accepted; read nowhere, as in the reference
    "xla_latency_hiding": False,  # accepted; warns that it has no meaning
    # the training mesh (parallel/mesh.py): ranks of torch.distributed
    "train_shard": False,         # gate; off = single device whatever the
    #                               mesh knobs say
    "mesh": {                     # the training mesh (train_shard on):
        "data": 1,                # batch sharding, gradients summed
        "model": 1,               # column-sharded wide FC weights
    },
    # ring attention over the sequence axis (attention.py)
    "seq_parallel": 0,            # ranks of the ("sp",) mesh; 0/1 = off
    # the snapshot formats (snapshotter.py)
    "snapshot_format": "pickle",  # "orbax": a directory, arrays written
    #                               with torch.distributed.checkpoint
    "snapshot_sharded": False,    # orbax: each rank writes its own rows
    # the master/slave star (server.py, client.py)
    "mode": "",                   # "master" | "slave" (--master/--slave)
    "master_bind": "tcp://*:5570",    # the reference's; --master with no
    #                                   BIND binds tcp://127.0.0.1:*
    "master_resume": "",          # the crash-resume file (--master-resume)
    "slave_endpoint": None,       # the master a slave works for (--slave)
    "job_segment": 1,             # non-tail TRAIN minibatches a job
    "job_prefetch": True,         # a slave fetches job N+1 during job N
    "job_timeout_mult": 8.0,      # reap after this x the median round trip
    "job_deadline": True,         # jobs carry their reap window as a budget
    "slave_ttl": 60.0,            # evict a slave silent this long (s)
    "slave_reconnects": 8,        # consecutive reconnects before giving up
    "slave_backoff_base": 0.25,   # reconnect backoff: base (s) ...
    "slave_backoff_cap": 5.0,     # ... doubling to this cap (s)
    "slave_breaker_failures": 4,  # consecutive failures open the breaker
    "ingress_rate_limit": 0.0,    # job requests a second a slave (0: off)
    "ingress_rate_burst": 0.0,    # its bucket's burst
    # the training plane's SLO: apply progress (accepted delta applies
    # against refused, stale and quarantined ones), advisory burn rates
    # on /slo.json, never a readiness gate
    "obs_slo_apply_progress": 0.99,
    "obs_slo_fast_window_s": 60.0,
    "obs_slo_slow_window_s": 600.0,
    "quarantine_norm_mult": 25.0,     # refuse deltas this x the median norm
    "master_snapshot_s": 10.0,    # the crash-resume file's period (s)
    "wire_dtype": "float32",      # deltas on the wire: bf16 / int8
    "wire_compress": "none",      # the params broadcast: zlib / lz4
    "min_slaves": 0,              # the quorum (0: no gate)
    "staleness_bound": 0,         # refuse deltas this many applies old
    "staleness_weight": False,    # scale a late delta by 1 / (1 + s)
    # the relay tree (parallel/relay.py)
    "tree_fanout": 2,             # children per relay; job-batch factor
    "relay_flush_s": 0.05,        # a partial flush after this long (s)
    "relay_child_ttl": 30.0,      # a relay drops a child silent this long
    "elastic_rehome": False,      # hand orphan leaves a live relay
}

#: The reference's other ``root.common.engine.*`` knobs
#: (``znicz_tpu/core/config.py`` ENGINE_DEFAULTS), which the port does not
#: read yet: knob (dotted below the engine) -> (the reference's default,
#: the ROADMAP item that ports it).  :func:`check_engine_knobs` refuses
#: each set away from its default.  Empty since the telemetry port read
#: the last of them (``obs_slo_*``); the check stays for the next.
UNPORTED_ENGINE_KNOBS: Dict[str, Tuple[Any, str]] = {}

_UNSET = object()
_warned_latency_hiding = False


def check_engine_knobs() -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    knob of :data:`UNPORTED_ENGINE_KNOBS` set away from the reference's
    default: the port would otherwise train as if it were unset.  With
    ``xla_latency_hiding`` on, warn once a process on stderr that the
    flags it names belong to XLA's scheduler, which PyTorch does not
    run."""
    global _warned_latency_hiding
    eng = root.common.engine
    if bool(eng.get("xla_latency_hiding", False)) \
            and not _warned_latency_hiding:
        _warned_latency_hiding = True
        print("warning: root.common.engine.xla_latency_hiding has no "
              "meaning under PyTorch (it sets XLA's latency-hiding "
              "scheduler flags); the port runs as without it",
              file=sys.stderr)
    for key, (default, item) in UNPORTED_ENGINE_KNOBS.items():
        value = eng.get_by_path(key, _UNSET)
        if value is not _UNSET and value != default:
            raise NotImplementedError(
                f"root.common.engine.{key}={value!r} is not ported yet "
                f"(ROADMAP queue {item}); the port runs as at its default "
                f"{default!r}")


#: The reference's ``root.common.serving.*`` keys
#: (``znicz_tpu/serving/frontend.py`` DEFAULTS) that the port does not read
#: yet: key (dotted below ``serving``) -> (the reference's default, the
#: ROADMAP item that ports it).  ``serving/frontend.DEFAULTS`` names the
#: keys the port reads; :func:`check_serving_keys` refuses each of these
#: set away from its default.  Empty since the telemetry port read the
#: last of them (``web_port`` and ``obs.*``).
UNPORTED_SERVING_KEYS: Dict[str, Tuple[Any, str]] = {}


def check_serving_keys() -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    key of :data:`UNPORTED_SERVING_KEYS` set away from the reference's
    default, as :func:`check_engine_knobs` refuses an engine knob: the
    service would otherwise run as if it were unset."""
    serving = root.common.serving
    for key, (default, item) in UNPORTED_SERVING_KEYS.items():
        value = serving.get_by_path(key, _UNSET)
        if value is not _UNSET and value != default:
            raise NotImplementedError(
                f"root.common.serving.{key}={value!r} is not ported yet "
                f"(ROADMAP queue {item}); the service runs as at its "
                f"default {default!r}")
