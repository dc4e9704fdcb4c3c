"""Snapshotter: best-on-validation and periodic checkpoints (port of
``znicz_tpu/snapshotter.py``: ``collect``, ``collect_meta``, ``restore``,
``restore_inference``, ``load_inference``, ``Snapshotter``, the host
pickle and the orbax directory format, ``load_orbax_meta``,
``load_orbax_arrays``).

A host-format snapshot is the reference's plain dict, pickled (gzip under
``compression="gz"``, the default: ``<prefix>_<tag>.pickle.gz``; any
other value writes a plain ``<prefix>_<tag>.pickle``), with numpy leaves
and no torch object::

    {"units": {forward unit: {"weights": ndarray, "bias": ndarray}},
     "velocities": {GD unit name: {param: ndarray}},
     "loader": {...}, "decision": {...}, "prng": {stream: state},
     "epoch": N, "metric": x, "time": t, "config": {...}}

so a file the port writes restores into the reference's workflow of the
same unit names, and the reverse.  Leaves are written float32 whatever
the live dtype (bf16 velocities under ``state_dtype``, bf16 parameters
under ``master_dtype``) and cast to the live dtype on restore.  A
reference snapshot saved under bf16 state holds ``ml_dtypes`` bf16
arrays; :meth:`Snapshotter.load` reads them without that package, as
float32 leaves of the same values.  A loader's ``normalizer`` state
rides in ``snap["loader"]["normalizer"]``, as the reference's does.

**The orbax format** (``format="orbax"``, or
``root.common.engine.snapshot_format``) writes the directory
``<prefix>_<tag>.orbax/``, the reference's layout: ``meta.json`` holds
everything but the arrays (:func:`_jsonify`: numpy arrays round-trip
exactly), ``arrays/`` the ``{"units", "velocities"}`` tree, written with
``torch.distributed.checkpoint`` (the reference writes it with orbax,
which the port cannot import: the reference cannot read the port's
``arrays/``, the port reads the reference's through ``tensorstore``).
The save is a collective every rank calls: rank 0 resets the directory
before any rank writes, each rank writes its part, rank 0 writes
``meta.json``, and it returns once all of it is on disk; an error on any
rank raises on every rank.  It is synchronous: ``save_async`` takes the
host format only.  With ``sharded`` (``snapshot_sharded``) the live
state is saved as it is placed: a leaf split over a mesh's ``model``
axis is a ``DTensor`` of each rank's rows, so each rank writes only its
own rows; without, the split leaves are gathered whole first.  A leaf
that several ranks hold (the replicated ones, and every leaf across the
``data`` axis) is written once.  :func:`load_orbax_arrays` with a
template of target tensors (a ``DTensor`` for a split leaf) reads only
each rank's rows, so a snapshot saved under one mesh restores under
another or onto one process (``FusedTrainer.restore_sharded``), with
no whole-array round trip through the host.

**On a mesh of ranks** (``parallel/mesh.py``) a host-format snapshot
holds whole arrays: :func:`collect` and :func:`snapshot_from_trees`
gather each column-sharded leaf over the ``model`` axis (a collective
every rank joins, on the main thread, in the units' order), and only
rank 0 writes
(:meth:`Snapshotter.save`, :meth:`Snapshotter.save_async`); the other
ranks set ``destination`` to the path rank 0 writes.  The reference
refuses a host-format save of state sharded across processes; the port
gathers it.  :func:`restore` gives each rank its rows of such a leaf, so
a meshed run's snapshot loads into one process and a single process's
into a mesh.

**Asynchronous saves** (``FusedTrainer`` under
``root.common.engine.async_snapshot``, on by default): at an epoch's end
the trainer takes device clones of the parameters and velocities and the
metadata as they stand (:func:`collect` with ``device_copies``) and hands
them to :meth:`Snapshotter.save_async`; one background thread copies the
clones to the host and writes the files while the next epoch runs.  The
deep pipeline, whose live state has run epochs ahead, saves a flushed
epoch's own state instead (:func:`snapshot_from_trees`).  A
queued "best" save that has not started is dropped when a newer one
arrives (``async_saves_coalesced``); interval saves are never dropped.
:meth:`Snapshotter.flush_async` waits until every queued save is
written, and raises a writer's error.

Telemetry: ``async_saves_written`` and ``async_saves_coalesced`` are the
``snapshotter`` scope's registry counters; the background device-to-host
pull is a ``snapshot/pull`` span and every host-format write (the
Snapshotter's and the master's crash-resume file) a ``snapshot/write``
span.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import shutil
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from znicz_torch import telemetry
from znicz_torch.core.config import root
from znicz_torch.core.units import Unit
from znicz_torch.parallel import mesh as mesh_mod
from znicz_torch.telemetry.metrics import registered_property


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 host copy: a bf16 velocity (``state_dtype``) or
    parameter (``master_dtype``) widens exactly, and the pickle needs no
    bf16 numpy type."""
    return t.detach().float().cpu().numpy().copy()


def _placement(unit) -> Optional[mesh_mod.Placement]:
    """The mesh placement of a forward unit's module, or of a GD unit's
    forward's; None off a mesh."""
    fwd = getattr(unit, "forward", unit)
    return mesh_mod.placement_of(getattr(fwd, "module", fwd))


def _whole(unit, leaves: Dict) -> Dict:
    """``leaves`` with each column-sharded one gathered whole over the
    mesh's ``model`` axis (a collective)."""
    place = _placement(unit)
    if place is None:
        return dict(leaves)
    return {k: place.full(k, t) for k, t in leaves.items()}


def _as_placed(unit, leaves: Dict) -> Dict:
    """``leaves`` as they are placed: each column-sharded one a
    ``DTensor`` of this rank's rows (``Placement.dtensor``)."""
    place = _placement(unit)
    if place is None:
        return {k: t.detach() for k, t in leaves.items()}
    return {k: place.dtensor(k, t.detach()) for k, t in leaves.items()}


def collect(workflow, device_copies: bool = False,
            placed: bool = False) -> Dict:
    """The snapshot dict of ``workflow``'s units: forward parameters,
    GD velocities (zeros before the first update), and
    :func:`collect_meta`'s metadata.  With ``device_copies`` the array
    leaves are clones on the device, in their live dtypes, for
    :meth:`Snapshotter.save_async` to copy out later.  On a mesh the
    column-sharded leaves are gathered whole, unless ``placed``: then
    every leaf is the live tensor, in its live dtype, a column-sharded
    one a ``DTensor`` of this rank's rows (a sharded orbax save)."""
    from znicz_torch.nn_units import ForwardBase, GradientDescentBase

    if placed:
        arrays = _as_placed
    else:
        leaf = (lambda t: t.detach().clone()) if device_copies else _numpy

        def arrays(unit, leaves):
            return {k: leaf(t) for k, t in _whole(unit, leaves).items()}
    snap = collect_meta(workflow)
    for unit in workflow:
        if isinstance(unit, ForwardBase) and unit.has_weights:
            snap["units"][unit.name] = arrays(unit, unit.params())
        elif isinstance(unit, GradientDescentBase):
            unit.init_velocities()
            snap["velocities"][unit.name] = arrays(unit, unit.velocities)
    return snap


def snapshot_from_trees(workflow, params: Dict, velocities: Dict) -> Dict:
    """:func:`collect`'s dict with its array leaves taken from the given
    trees instead of the live units: ``params`` ``{forward unit name:
    {param: tensor}}``, ``velocities`` ``{GD unit name: {param:
    tensor}}`` (a GD unit they do not name has no leaves: one whose
    forward has no weights).  The leaves are kept as they are, for
    :meth:`Snapshotter.save_async` to copy out, a column-sharded one
    gathered whole on a mesh; the metadata is :func:`collect_meta`'s."""
    from znicz_torch.nn_units import ForwardBase, GradientDescentBase

    snap = collect_meta(workflow)
    for unit in workflow:
        if isinstance(unit, ForwardBase) and unit.has_weights:
            snap["units"][unit.name] = _whole(unit, params[unit.name])
        elif isinstance(unit, GradientDescentBase):
            snap["velocities"][unit.name] = _whole(
                unit, velocities.get(unit.name, {}))
    return snap


def collect_meta(workflow) -> Dict:
    """The non-array half of a snapshot: the loader's position and TRAIN
    order, the Decision's best metric, every named prng stream's state."""
    from znicz_torch.core import prng
    from znicz_torch.decision import DecisionBase
    from znicz_torch.loader.base import Loader

    snap: Dict = {"units": {}, "velocities": {}, "loader": {},
                  "decision": {}, "prng": {}, "time": time.time()}
    for unit in workflow:
        if isinstance(unit, Loader):
            snap["loader"] = {
                "epoch_number": unit.epoch_number,
                "samples_served": unit.samples_served,
                # epoch_number advances lazily: a boundary snapshot keeps
                # the tail state so a resumed loader starts the next epoch
                "last_minibatch": bool(unit.last_minibatch),
            }
            if unit._shuffled_indices is not None:
                snap["loader"]["shuffled_indices"] = \
                    np.array(unit._shuffled_indices)
            norm = getattr(unit, "normalizer", None)
            if norm is not None:
                snap["loader"]["normalizer"] = norm.state()
        elif isinstance(unit, DecisionBase):
            snap["decision"] = {"best_metric": unit.best_metric,
                                "best_epoch": unit.best_epoch,
                                "fails": unit._fails}
            snap["epoch"] = int(unit.epoch_number)
            snap["metric"] = float(unit.best_metric)
    snap["prng"] = {name: s.state.bit_generator.state
                    for name, s in prng._streams.items()}
    return snap


def _assign(param: torch.Tensor, value, place=None, key="") -> None:
    """Copy a snapshot leaf into ``param``, cast to the live dtype (a
    float32 leaf into a bf16 velocity rounds to nearest even), as the
    reference's restore casts it; with a mesh ``place``ment, this rank's
    rows of a column-sharded leaf."""
    value = np.array(value, np.float32)
    if place is not None:
        value = place.local(key, value)
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def restore(workflow, snap: Dict) -> None:
    """Apply a snapshot dict onto a built workflow, in place."""
    from znicz_torch.core import prng
    from znicz_torch.decision import DecisionBase
    from znicz_torch.loader.base import Loader
    from znicz_torch.nn_units import ForwardBase, GradientDescentBase

    for unit in workflow:
        if isinstance(unit, ForwardBase) and unit.name in snap["units"]:
            for k, p in unit.params().items():
                _assign(p, snap["units"][unit.name][k], _placement(unit), k)
        elif isinstance(unit, GradientDescentBase) and \
                unit.name in snap.get("velocities", {}):
            unit.init_velocities()
            for k, v in unit.velocities.items():
                _assign(v, snap["velocities"][unit.name][k],
                        _placement(unit), k)
        elif isinstance(unit, Loader) and snap.get("loader"):
            unit.epoch_number = snap["loader"]["epoch_number"]
            unit.samples_served = snap["loader"].get("samples_served", 0)
            unit.last_minibatch = snap["loader"].get("last_minibatch",
                                                     False)
            order = snap["loader"].get("shuffled_indices")
            if order is not None:
                unit._shuffled_indices = np.asarray(order, np.int32).copy()
            norm = getattr(unit, "normalizer", None)
            if norm is not None and "normalizer" in snap["loader"]:
                norm.restore(snap["loader"]["normalizer"])
        elif isinstance(unit, DecisionBase) and snap.get("decision"):
            unit.best_metric = snap["decision"]["best_metric"]
            unit.best_epoch = snap["decision"]["best_epoch"]
            unit._fails = snap["decision"]["fails"]
    for name, state in snap.get("prng", {}).items():
        prng.get(name).state.bit_generator.state = state


def _covering_units(workflow, snap: Dict) -> Dict:
    """``snap["units"]``; raises ``ValueError`` when it does not cover
    every forward module with weights (serving half a model would answer
    garbage)."""
    units = snap.get("units") or {}
    missing = [f.name for f in workflow.forwards
               if f.has_weights and f.name not in units]
    if missing:
        raise ValueError(
            f"snapshot has no params for weighted forward(s) {missing}; "
            f"it covers {sorted(units)}")
    return units


def restore_inference(workflow, snap: Dict) -> None:
    """Apply only the forward parameters (the serving load).  Raises when
    the snapshot does not cover every forward module with weights."""
    from znicz_torch.nn_units import params_of

    units = _covering_units(workflow, snap)
    for f in workflow.forwards:
        for k, p in params_of(f).items():
            _assign(p, units[f.name][k], mesh_mod.placement_of(f), k)


def inference_params(workflow, snap: Dict) -> Dict:
    """The forward parameters of ``snap`` as a new ``{module: {param:
    tensor}}`` tree on the workflow's device, each in its live
    parameter's dtype and shape, leaving the modules untouched (a
    served swap).  A module a meshed trainer split takes this rank's
    part of each whole leaf.  Raises as :func:`restore_inference` does,
    and on a leaf of another shape."""
    from znicz_torch.nn_units import params_of
    from znicz_torch.parallel.mesh import placement_of

    units = _covering_units(workflow, snap)
    tree = {}
    for f in workflow.forwards:
        leaves = {}
        place = placement_of(f)
        for k, p in params_of(f).items():
            value = np.asarray(units[f.name][k], np.float32)
            if place is not None:
                value = place.local(k, value)
            if value.shape != tuple(p.shape):
                raise ValueError(f"snapshot {f.name}.{k} is {value.shape}, "
                                 f"the model's {tuple(p.shape)}")
            leaves[k] = torch.from_numpy(value).to(p.device, p.dtype)
        if leaves:
            tree[f.name] = leaves
    return tree


def load_inference(workflow, path: str) -> Dict:
    """Load ``path`` (a host-format file or an orbax directory) and
    :func:`restore_inference` it; returns the snapshot's metadata
    (epoch, metric, config: what a server shows of its live checkpoint)
    without the arrays."""
    snap = Snapshotter.load(path)
    restore_inference(workflow, snap)
    return {k: v for k, v in snap.items()
            if k not in ("units", "velocities")}


class Snapshotter(Unit):
    """Writes snapshots at epoch ends.  Gate it with
    ``~decision.epoch_ended`` and give it ``improved`` and
    ``epoch_number`` from the decision; then

      - validation improved      -> ``<prefix>_best`` (at most once in
        ``min_save_interval_s`` seconds);
      - every ``interval`` epochs -> ``<prefix>_epoch_<N>`` (0 = off).

    ``format`` ("pickle" or "orbax") and ``sharded`` default to
    ``root.common.engine.snapshot_format`` and ``snapshot_sharded``.
    """

    FORMATS = ("pickle", "orbax")

    #: the writer's registry counters (``snapshotter`` scope): name ->
    #: HELP
    COUNTERS = {
        "async_saves_written": "files written by the async worker",
        "async_saves_coalesced": "superseded queued jobs dropped",
    }

    def __init__(self, workflow=None, name: str = "snapshotter",
                 prefix: str = "wf", directory: Optional[str] = None,
                 interval: int = 0,
                 min_save_interval_s: Optional[float] = None,
                 compression: str = "gz", format: Optional[str] = None,
                 sharded: Optional[bool] = None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        eng = root.common.engine
        self.compression = compression
        self.format = (format if format is not None
                       else eng.get("snapshot_format", "pickle"))
        if self.format not in self.FORMATS:
            raise ValueError(f"Snapshotter(format={self.format!r}): one of "
                             f"{self.FORMATS}")
        #: orbax only: save the live state as placed, each rank its rows
        self.sharded = bool(sharded if sharded is not None
                            else eng.get("snapshot_sharded", False))
        self.prefix = prefix
        self.directory = (directory if directory is not None
                          else root.common.dirs.get("snapshots",
                                                    "snapshots"))
        self.interval = int(interval)              # 0 = best-only
        self.min_save_interval_s = float(
            min_save_interval_s if min_save_interval_s is not None
            else root.common.engine.get("snapshot_min_interval_s", 0.0))
        self._last_best_save_t = -1e18
        self._last_saved_epoch = -1
        self.destination: Optional[str] = None     # the last path written
        self.improved = False                      # linked from decision
        self.epoch_number = 0                      # linked from decision
        #: files the background writer wrote, and queued best saves a
        #: newer one superseded before they started
        _sc = telemetry.scope("snapshotter")
        self._m = {name: _sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        self._async_lock = threading.Condition()
        self._async_pending: list = []
        self._async_thread: Optional[threading.Thread] = None
        self._async_busy = False
        self._async_error: Optional[BaseException] = None

    def snapshot_path(self, tag: str) -> str:
        if self.format == "orbax":
            return os.path.join(self.directory, f"{self.prefix}_{tag}.orbax")
        ext = ".pickle.gz" if self.compression == "gz" else ".pickle"
        return os.path.join(self.directory, f"{self.prefix}_{tag}{ext}")

    def save(self, tag: str) -> str:
        """Collect the workflow (every rank of a mesh joins) and write it
        under ``tag``: a host-format file on rank 0 only; an orbax
        directory with every rank writing its part (:func:`save_orbax`)."""
        path = self.snapshot_path(tag)
        if self.format == "orbax":
            snap = collect(self.workflow, device_copies=not self.sharded,
                           placed=self.sharded)
            snap["config"] = root.to_dict()
            save_orbax(path, snap)
            self.destination = path
            self.info("snapshot -> %s", path)
            return path
        snap = collect(self.workflow)
        if mesh_mod.process_index() != 0:
            self.destination = path
            return path
        os.makedirs(self.directory, exist_ok=True)
        snap["config"] = root.to_dict()
        write_host_pickle(path, snap, self.compression)
        self.destination = path
        self.info("snapshot -> %s", path)
        return path

    def _interval_due(self, epoch: int) -> bool:
        return bool(self.interval and epoch != self._last_saved_epoch and
                    (epoch + 1) % self.interval == 0)

    def _best_due(self, improved) -> bool:
        """Whether a best save is due; across ranks rank 0's clock decides
        (a save is a collective on a mesh)."""
        if not improved:
            return False
        due = time.time() - self._last_best_save_t >= self.min_save_interval_s
        return bool(mesh_mod.agree(due) if self.min_save_interval_s > 0
                    else due)

    def due(self, epoch: int, improved) -> bool:
        """Whether :meth:`run` would write anything for this epoch."""
        return self._best_due(improved) or self._interval_due(int(epoch))

    def run(self):
        if self._best_due(self.improved):
            self._last_best_save_t = time.time()
            self.save("best")
        epoch = int(self.epoch_number)
        if self._interval_due(epoch):
            self.save(f"epoch_{epoch}")
            self._last_saved_epoch = epoch

    # -- asynchronous saves ----------------------------------------------------

    def tags_for(self, epoch: int, improved) -> list:
        """The tags :meth:`run` would write for this epoch, its interval
        and rate bookkeeping taken as :meth:`run` takes it."""
        tags = []
        if self._best_due(improved):
            self._last_best_save_t = time.time()
            tags.append("best")
        epoch = int(epoch)
        if self._interval_due(epoch):
            tags.append(f"epoch_{epoch}")
            self._last_saved_epoch = epoch
        return tags

    def save_async(self, snap: Dict, tags, ready=None) -> None:
        """Queue ``snap`` (array leaves may be device tensors) to be
        written under each of ``tags`` by the background writer.
        ``ready``, a CUDA event recorded after the leaves were made, is
        waited on before they are copied out.  A writer error from an
        earlier save is raised here.  A rank other than 0 writes nothing
        and sets ``destination`` to the path rank 0 writes last.  The
        host format only: an orbax save is a synchronous collective."""
        if self.format != "pickle":
            raise ValueError(f"save_async writes the host format; "
                             f"format={self.format!r} saves with save()")
        if mesh_mod.process_index() != 0:
            if tags:
                self.destination = self.snapshot_path(tags[-1])
            return
        with self._async_lock:
            if self._async_error is not None:
                err, self._async_error = self._async_error, None
                raise err
            if "best" in tags:
                # a queued best that has not started is superseded: same
                # file, older weights; its interval tags stay queued
                kept = []
                for snap_p, tags_p, ready_p in self._async_pending:
                    rest = [t for t in tags_p if t != "best"]
                    self._m["async_saves_coalesced"].inc(
                        len(tags_p) - len(rest))
                    if rest:
                        kept.append((snap_p, rest, ready_p))
                self._async_pending = kept
            self._async_pending.append((snap, list(tags), ready))
            if self._async_thread is None:
                self._async_thread = threading.Thread(
                    target=self._async_worker, daemon=True,
                    name="znicz-snapshot")
                self._async_thread.start()
            self._async_lock.notify_all()

    def _async_worker(self) -> None:
        while True:
            with self._async_lock:
                while not self._async_pending:
                    self._async_lock.wait()
                snap, tags, ready = self._async_pending.pop(0)
                self._async_busy = True
            try:
                # the device -> host pull happens here, off the training
                # thread
                with telemetry.span("snapshot", "pull", tags=list(tags)):
                    if ready is not None:
                        ready.synchronize()
                    for group in ("units", "velocities"):
                        for leaves in snap.get(group, {}).values():
                            for k, a in leaves.items():
                                if isinstance(a, torch.Tensor):
                                    leaves[k] = _numpy(a)
                os.makedirs(self.directory, exist_ok=True)
                for tag in tags:
                    path = self.snapshot_path(tag)
                    write_host_pickle(path, snap, self.compression)
                    with self._async_lock:
                        self.destination = path
                    self._m["async_saves_written"].inc()
                    self.info("snapshot (async) -> %s", path)
            except BaseException as exc:     # raised by flush/next save
                with self._async_lock:
                    self._async_error = exc
            finally:
                with self._async_lock:
                    self._async_busy = False
                    self._async_lock.notify_all()

    def flush_async(self) -> None:
        """Wait until every queued save is written; raise a writer's
        error."""
        with self._async_lock:
            while self._async_pending or self._async_busy:
                self._async_lock.wait(timeout=0.5)
            if self._async_error is not None:
                err, self._async_error = self._async_error, None
                raise err

    @staticmethod
    def load(path: str) -> Dict:
        """The snapshot at ``path``, a host-format file or an orbax
        directory (the port's or the reference's), with numpy leaves;
        bf16 leaves (the reference's velocities under bf16 state, as
        ``ml_dtypes`` arrays in a pickle) come back as float32 leaves of
        the same values, whether ``ml_dtypes`` is installed or not."""
        if path.rstrip("/").endswith(".orbax") or os.path.isdir(path):
            return _load_orbax(path.rstrip("/"))
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            unpickler = _Unpickler(f)
            snap = unpickler.load()
        return _widen_bf16(snap) if unpickler.read_bf16 else snap


class _Unpickler(pickle.Unpickler):
    """Reads the class ``ml_dtypes.bfloat16`` as ``np.uint16``, so that an
    ``ml_dtypes`` bf16 array unpickles as a uint16 array of its bits;
    ``read_bf16`` says whether one did."""

    def __init__(self, f):
        super().__init__(f)
        self.read_bf16 = False

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            self.read_bf16 = True
            return np.uint16
        return super().find_class(module, name)


def _widen_bf16(tree):
    """``tree`` with every uint16 array (the bits of a bf16 one: the
    reference writes no uint16 leaf) widened exactly to float32."""
    if isinstance(tree, dict):
        return {k: _widen_bf16(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.uint16:
        return _bf16_bits_to_f32(tree)
    return tree


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


for _name, _help in Snapshotter.COUNTERS.items():
    setattr(Snapshotter, _name, registered_property(_name, _help))
del _name, _help


def write_host_pickle(path: str, snap: Dict, compression: str = "gz") -> None:
    """Write ``snap`` to a temporary file and rename it over ``path``, so a
    crash mid-write never truncates the previous checkpoint."""
    tmp = path + ".tmp"
    opener = gzip.open if compression == "gz" else open
    try:
        # the span of every host-format write: the Snapshotter's sync and
        # async saves and the master's crash-resume file
        with telemetry.span("snapshot", "write", path=path,
                            compression=compression):
            with opener(tmp, "wb") as f:
                pickle.dump(snap, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomic byte-blob write (temp file named after the pid, then
    rename)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# -- the orbax directory format ------------------------------------------------


def _jsonify(obj):
    """JSON for ``meta.json`` in which numpy arrays round-trip exactly
    (the reference's encoding): an array of more than 1024 elements as
    base64 bytes with its dtype and shape, a smaller one as a list with
    its dtype; numpy scalars as Python numbers."""
    if isinstance(obj, np.ndarray):
        if obj.size > 1024:
            import base64

            return {"__ndarray_b64__":
                    base64.b64encode(np.ascontiguousarray(obj)
                                     .tobytes()).decode("ascii"),
                    "__dtype__": str(obj.dtype),
                    "__shape__": list(obj.shape)}
        return {"__ndarray__": obj.tolist(), "__dtype__": str(obj.dtype)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def _dejsonify(obj):
    """The inverse of :func:`_jsonify`."""
    if isinstance(obj, dict):
        if set(obj) == {"__ndarray__", "__dtype__"}:
            return np.asarray(obj["__ndarray__"], dtype=obj["__dtype__"])
        if set(obj) == {"__ndarray_b64__", "__dtype__", "__shape__"}:
            import base64

            return np.frombuffer(
                base64.b64decode(obj["__ndarray_b64__"]),
                dtype=obj["__dtype__"]).reshape(obj["__shape__"]).copy()
        return {k: _dejsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dejsonify(v) for v in obj]
    return obj


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _distributed() -> bool:
    return mesh_mod.world_size() > 1


def save_orbax(path: str, snap: Dict) -> None:
    """Write ``snap`` as the orbax directory ``path``: ``arrays/`` (its
    ``units`` and ``velocities``, tensors or ``DTensor``s, through
    ``torch.distributed.checkpoint``) and ``meta.json`` (the rest).  A
    collective: every rank calls it.  Rank 0 resets the directory, and
    no rank writes before it has; each rank writes its own part of the
    arrays (a leaf several ranks hold is written once); rank 0 writes
    ``meta.json``; every rank returns once all of it is on disk.  An
    error on any rank raises on every rank."""
    path = os.path.abspath(path)
    rank0 = mesh_mod.process_index() == 0
    error = None
    if rank0:
        try:
            if os.path.exists(path):
                shutil.rmtree(path)
            os.makedirs(path)
        except OSError as exc:
            error = exc
    mesh_mod.raise_anywhere(error, f"resetting {path}")
    arrays = {"units": snap["units"], "velocities": snap["velocities"]}
    with warnings.catch_warnings():
        # one process: the checkpoint says it saves without a group
        warnings.simplefilter("ignore", UserWarning)
        _dcp().save(arrays, checkpoint_id=os.path.join(path, "arrays"),
                    no_dist=not _distributed())
    error = None
    if rank0:
        try:
            meta = {k: v for k, v in snap.items()
                    if k not in ("units", "velocities")}
            atomic_write_bytes(os.path.join(path, "meta.json"), json.dumps(
                _jsonify(meta), default=repr).encode())
        except Exception as exc:      # raised on every rank just below
            error = exc
    mesh_mod.raise_anywhere(error, f"writing {path}/meta.json")


def load_orbax_meta(path: str) -> Dict:
    """The metadata of the orbax directory ``path``: the snapshot but
    its arrays."""
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return _dejsonify(json.load(f))


def load_orbax_arrays(path: str, template: Optional[Dict] = None) -> Dict:
    """The ``{"units", "velocities"}`` tree of the orbax directory
    ``path``.  Without ``template``: whole numpy leaves, bf16 ones
    widened to float32.  With ``template`` (the same tree of target
    tensors, each in the dtype and on the device wanted; a ``DTensor``
    for a leaf split over a mesh): each target filled in place, cast to
    its dtype, a ``DTensor`` with only this rank's rows read, and the
    template returned; a collective when the world has several ranks.
    Reads the port's directories (``torch.distributed.checkpoint``) and
    the reference's (orbax's OCDBT + zarr, through ``tensorstore``)."""
    arrays = os.path.join(os.path.abspath(path), "arrays")
    if not os.path.exists(os.path.join(arrays, ".metadata")):
        return _reference_arrays(arrays, template)
    if template is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _dcp().load(template, checkpoint_id=arrays,
                        no_dist=not _distributed())
        return template
    from torch.distributed.checkpoint import FileSystemReader

    md = FileSystemReader(arrays).read_metadata()
    tree: Dict = {"units": {}, "velocities": {}}
    for fqn, leaf in md.state_dict_metadata.items():
        group, name, key = _leaf_path(md, fqn)
        tree.setdefault(group, {}).setdefault(name, {})[key] = torch.empty(
            tuple(leaf.size), dtype=leaf.properties.dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        _dcp().load(tree, checkpoint_id=arrays, no_dist=True)
    return {group: {name: {k: _numpy(t) if t.dtype == torch.bfloat16
                           else t.numpy() for k, t in leaves.items()}
                    for name, leaves in names.items()}
            for group, names in tree.items()}


def _leaf_path(md, fqn: str):
    """(group, unit, param) of the flattened key ``fqn``."""
    path = (md.planner_data or {}).get(fqn)
    return tuple(path) if path else tuple(fqn.split(".", 2))


def _reference_arrays(arrays: str, template: Optional[Dict]) -> Dict:
    """The reference's orbax ``arrays/`` (OCDBT with a zarr array a
    leaf, named in ``_METADATA``), read with ``tensorstore``: whole
    numpy leaves, or each ``template`` leaf filled with them (a
    ``DTensor`` with this rank's rows)."""
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise RuntimeError(
            f"{arrays} is an orbax directory of the reference (OCDBT + "
            "zarr); reading it needs the tensorstore package, which does "
            "not import here") from exc
    with open(os.path.join(arrays, "_METADATA")) as f:
        tree_md = json.load(f)["tree_metadata"]
    base = {"driver": "ocdbt", "base": f"file://{arrays}"}
    tree: Dict = {"units": {}, "velocities": {}}
    for entry in tree_md.values():
        group, name, key = (k["key"] for k in entry["key_metadata"])
        store = ts.open({"driver": "zarr", "kvstore": dict(
            base, path=f"{group}.{name}.{key}/")}, open=True).result()
        a = np.asarray(store.read().result())
        if a.dtype.name == "bfloat16":
            a = _bf16_bits_to_f32(a.view(np.uint16))
        tree.setdefault(group, {}).setdefault(name, {})[key] = a
    if template is None:
        return tree
    for group, names in template.items():
        for name, leaves in names.items():
            for key, target in leaves.items():
                value = torch.from_numpy(np.ascontiguousarray(
                    tree[group][name][key]))
                with torch.no_grad():
                    local_tensor(target).copy_(_own_part(target, value))
    return template


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local part; any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _own_part(target: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``whole`` for ``target``: ``whole`` itself,
    or a ``DTensor`` target's rows (its ``Shard`` placements, even
    splits)."""
    if not hasattr(target, "to_local"):
        return whole
    coord = target.device_mesh.get_coordinate()
    for dim, placement in enumerate(target.placements):
        if placement.is_shard():
            n = target.device_mesh.size(dim)
            whole = whole.chunk(n, dim=placement.dim)[coord[dim]]
    return whole


def _load_orbax(path: str) -> Dict:
    """The snapshot dict of the orbax directory ``path``: its metadata
    and whole numpy leaves."""
    return {**load_orbax_meta(path), **load_orbax_arrays(path)}
