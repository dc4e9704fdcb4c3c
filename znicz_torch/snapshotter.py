"""Snapshotter: best-on-validation and periodic checkpoints, host-pickle
format (port of ``znicz_tpu/snapshotter.py``'s ``collect``,
``collect_meta``, ``restore``, ``restore_inference``, ``Snapshotter``,
``write_host_pickle`` and ``atomic_write_bytes``).

A snapshot is the reference's plain dict, gzip-pickled, with numpy
leaves and no torch object::

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
rides in ``snap["loader"]["normalizer"]``, as the reference's does.  The
reference's orbax format is not ported (ROADMAP A.4): :class:`Snapshotter`
refuses ``compression`` other than "gz", ``format`` other than "pickle"
and ``sharded=True``.

**On a mesh of ranks** (``parallel/mesh.py``) a snapshot still holds
whole arrays: :func:`collect` and :func:`snapshot_from_trees` gather each
column-sharded leaf over the ``model`` axis (a collective every rank
joins, on the main thread, in the units' order), and only rank 0 writes
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
"""

from __future__ import annotations

import gzip
import os
import pickle
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from znicz_torch.core.config import refuse_keyword, root
from znicz_torch.core.units import Unit
from znicz_torch.parallel import mesh as mesh_mod


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


def collect(workflow, device_copies: bool = False) -> Dict:
    """The snapshot dict of ``workflow``'s units: forward parameters,
    GD velocities (zeros before the first update), and
    :func:`collect_meta`'s metadata.  With ``device_copies`` the array
    leaves are clones on the device, in their live dtypes, for
    :meth:`Snapshotter.save_async` to copy out later.  On a mesh the
    column-sharded leaves are gathered whole."""
    from znicz_torch.nn_units import ForwardBase, GradientDescentBase

    leaf = (lambda t: t.detach().clone()) if device_copies else _numpy
    snap = collect_meta(workflow)
    for unit in workflow:
        if isinstance(unit, ForwardBase) and unit.has_weights:
            snap["units"][unit.name] = {
                k: leaf(p) for k, p in _whole(unit, unit.params()).items()}
        elif isinstance(unit, GradientDescentBase):
            unit.init_velocities()
            snap["velocities"][unit.name] = {
                k: leaf(v)
                for k, v in _whole(unit, unit.velocities).items()}
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


def restore_inference(workflow, snap: Dict) -> None:
    """Apply only the forward parameters (the serving load).  Raises when
    the snapshot does not cover every forward module with weights."""
    units = snap.get("units") or {}
    missing = [f.name for f in workflow.forwards
               if f.has_weights and f.name not in units]
    if missing:
        raise ValueError(
            f"snapshot has no params for weighted forward(s) {missing}; "
            f"it covers {sorted(units)}")
    from znicz_torch.nn_units import params_of

    for f in workflow.forwards:
        for k, p in params_of(f).items():
            _assign(p, units[f.name][k], mesh_mod.placement_of(f), k)


class Snapshotter(Unit):
    """Writes snapshots at epoch ends.  Gate it with
    ``~decision.epoch_ended`` and give it ``improved`` and
    ``epoch_number`` from the decision; then

      - validation improved      -> ``<prefix>_best`` (at most once in
        ``min_save_interval_s`` seconds);
      - every ``interval`` epochs -> ``<prefix>_epoch_<N>`` (0 = off).
    """

    def __init__(self, workflow=None, name: str = "snapshotter",
                 prefix: str = "wf", directory: Optional[str] = None,
                 interval: int = 0,
                 min_save_interval_s: Optional[float] = None,
                 compression: str = "gz", format: str = "pickle",
                 sharded: bool = False, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        for key, value, accepted in (("compression", compression, ("gz",)),
                                     ("format", format, ("pickle",)),
                                     ("sharded", sharded, (False,))):
            refuse_keyword("Snapshotter", key, value, accepted, "A.4")
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
        self.async_saves_written = 0
        self.async_saves_coalesced = 0
        self._async_lock = threading.Condition()
        self._async_pending: list = []
        self._async_thread: Optional[threading.Thread] = None
        self._async_busy = False
        self._async_error: Optional[BaseException] = None

    def snapshot_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{tag}.pickle.gz")

    def save(self, tag: str) -> str:
        """Collect the workflow (every rank of a mesh joins) and write it
        under ``tag``: on rank 0 only."""
        path = self.snapshot_path(tag)
        snap = collect(self.workflow)
        if mesh_mod.process_index() != 0:
            self.destination = path
            return path
        os.makedirs(self.directory, exist_ok=True)
        snap["config"] = root.to_dict()
        write_host_pickle(path, snap)
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
        and sets ``destination`` to the path rank 0 writes last."""
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
                    self.async_saves_coalesced += len(tags_p) - len(rest)
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
                    write_host_pickle(path, snap)
                    with self._async_lock:
                        self.destination = path
                        self.async_saves_written += 1
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
        """The snapshot at ``path``; ``ml_dtypes`` bf16 leaves (the
        reference's velocities under bf16 state) come back as float32
        leaves of the same values, whether that package is installed or
        not."""
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
        return (tree.astype(np.uint32) << 16).view(np.float32)
    return tree


def write_host_pickle(path: str, snap: Dict, compression: str = "gz") -> None:
    """Write ``snap`` to a temporary file and rename it over ``path``, so a
    crash mid-write never truncates the previous checkpoint."""
    tmp = path + ".tmp"
    opener = gzip.open if compression == "gz" else open
    try:
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
