"""ModelRunner: a built workflow frozen into an inference forward (port
of ``znicz_tpu/serving/model.py``'s scoring runner: the rung family, the
snapshot load, swap and rollback, the compute-fault hook and the serving
mesh).

The forward IS ``FusedTrainer.forward_pass(train=False)``, the same
routing the reference serves.  Parameters stay on the workflow's device
and are never written by a dispatch; every dispatch runs under
``torch.inference_mode()``.  The output is the last module's: LOGITS for
a softmax head.

**The rung family** (the reference's bucketed jit cache).  On a CUDA
device each distinct batch shape (a ladder rung) is captured once as a
CUDA graph (``parallel/graphs.StepGraph``): the shape's first dispatch
runs eagerly on ``graphs.capture_stream`` (cuDNN's choice and the kernel
builds happen there), the device is synchronised, and the forward is
captured in the ``thread_local`` error mode; that dispatch answers with
its eager result.  Every later dispatch of the shape copies its input
into the graph's static input and replays.  ``compiles`` counts the
captures (on an uncaptured runner, the first dispatch of each shape), and
``graph_cache_size()`` the live generation's family: after
``warmup(ladder)`` both equal ``len(ladder.rungs)``, and traffic adds
none.  A capture that fails raises: there is no fall back to eager.
``capture`` (default: on a CUDA device with no ``uncaptured_reason`` of
the trainer's) may be False to serve eagerly; True where the device or
the trainer forbids a capture raises.  The design's choices:

  - *Parameters live at fixed addresses in a graph*, so each generation
    (parameter tree) owns its family.  A swap captures the new tree's
    family while it warms, rung by rung under the dispatch lock; the
    displaced generation keeps its family, so a rollback replays it
    without a capture; a family displaced twice (or dropped by a
    rollback) is freed.  Each family's captures share one private
    memory pool, so a capture during traffic never takes blocks of the
    live family.  Rungs of one family may share pool blocks: their
    replays run one at a time on one stream, and each dispatch's result
    is cloned before the next replay;
  - *Ping-pong staging*: the frontend stages batch N+1 on the copy
    stream while N computes, and both may ride one rung.  The staged
    tensor is copied into the static input on the compute stream, after
    the staging event and before the replay (a device-to-device copy,
    79 MB at 128 AlexNet rows), rather than keeping two input slots a
    rung: one graph a rung reads one address, and two slots would take
    two captures a rung;
  - *Static outputs* are overwritten by the next replay, so a dispatch
    returns a device clone of them (0.5 MB at 128 rows x 1000 logits);
  - *A capture sees a quiet device*: it synchronises first, under the
    dispatch lock, so the compute thread waits for one rung's capture
    and no longer; a capture that fails during a swap counts in
    ``swap_failures`` and the old generation serves on;
  - uint8 samples decode (``FusedTrainer._decode``) inside the graph.

**Staging**: :meth:`stage` copies a host batch to the device from pinned
memory on a side stream and records an event; :meth:`infer_staged`
makes the compute stream wait on that event, so staging batch N+1
overlaps the compute of batch N.  :meth:`host_buffer` hands out the
pinned buffer a batch is assembled in, so the assembly is the only host
copy.

**Generations.**  ``ModelRunner(workflow, snapshot=path)`` loads the
snapshot's forward parameters into the modules before it freezes them.
The served generation is one ``(tree, generation, family)`` tuple, read
once a dispatch under the runner's dispatch lock; the port's forward
reads the modules' own parameters, so a dispatch binds its tree to the
modules for the length of its forward (or of its capture) and stamps its
reply with the generation.  :meth:`swap` loads a snapshot into a new
tree (never into the live modules), warms it through every ladder rung
(each warm dispatch takes the lock, so served batches interleave and
each sees exactly one generation), then flips the tuple; the id comes
from a high-water mark, and the displaced tuple is kept for one
disk-free :meth:`rollback`.  A concurrent swap, a snapshot that does not
cover the model, or a failed warm raises, is counted in
``swap_failures``, and leaves the live generation serving.

**Compute faults**: :meth:`inject_compute_faults` arms a chaos
``FaultSchedule``; every dispatch, the warm's included, takes one
``decide_compute`` decision (the cursor advances under the dispatch
lock), and a ``stall`` sleeps on the host before the dispatch; stalls
count in ``stats()["stalls"]``.

**The serving mesh** (``root.common.serving.mesh.{data,model}``).  A mesh is a group of processes, one a rank
(``parallel/mesh.py``).  Every rank builds the workflow and a
``ModelRunner``; rank 0 serves (its frontend binds and batches) and the
others call :meth:`follow`.  For each step rank 0 broadcasts a header
(infer with its rows and generation, load, flip, drop, rollback, stop);
for an infer it scatters each data coordinate its ``rows / dp`` rows
from the host, every rank runs the meshed forward on its rows (wide FC
layers split over ``model``), and rank 0 gathers the logits.  A swap
loads on every rank and the ranks agree on the load's outcome
(``mesh.raise_anywhere``: a load that fails on one rank fails on all,
and every rank serves on), the warm dispatches run on every rank, and
the flip carries the new generation id, which every infer header is
checked against: no dispatch mixes generations across ranks.  On a mesh
a swap's load holds the dispatches (each rank loads in its exchange
loop), and the rungs must divide by dp (``BucketLadder(dp=...)``).
Meshed dispatches are not captured, for the training mesh's reason.

The AOT executable cache waits for the rest of ROADMAP A.6 (after the
balancer), generation serving for A.8.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from znicz_torch.core.config import ENGINE_DEFAULTS, root
from znicz_torch.parallel import mesh as mesh_mod
from znicz_torch.parallel.fused import FusedTrainer
from znicz_torch.parallel.graphs import StepGraph, capture_stream


class Staged(NamedTuple):
    """A batch on its way to the device: the device tensor (on a mesh,
    the host batch rank 0 scatters), the event its copy completes on
    (None on the CPU), and the host buffer it came from, kept alive
    until the copy is done."""

    x: torch.Tensor
    event: Optional[object]
    host: Optional[torch.Tensor]


class Family:
    """One generation's rung family: each batch key's captured
    :class:`StepGraph` (None on an uncaptured runner: the keys entered)
    and the memory pool its captures share."""

    def __init__(self, pool=None):
        self.pool = pool
        self.graphs: Dict[tuple, Optional[StepGraph]] = {}

    def __len__(self) -> int:
        return len(self.graphs)

    def release(self) -> None:
        for graph in self.graphs.values():
            if graph is not None:
                graph.release()
        self.graphs.clear()


class Generation(NamedTuple):
    """A served parameter tree, its generation id (0 while a swap warms
    it) and its rung family."""

    tree: Dict
    gen: int
    family: Family


#: the mesh's exchange: rank 0 broadcasts (op, rows, generation) before
#: each step every rank takes together
INFER, LOAD, FLIP, DROP, ROLLBACK, STOP = range(1, 7)


class ModelRunner:
    """Freeze a built workflow (``StandardWorkflow``) into its inference
    forward on the workflow's device (see the module docstring for
    ``capture`` and ``mesh``)."""

    def __init__(self, workflow, snapshot: str = "",
                 capture: Optional[bool] = None):
        if snapshot:
            from znicz_torch import snapshotter

            snapshotter.load_inference(workflow, snapshot)
        self.workflow = workflow
        self.device: torch.device = workflow.device
        #: the serving mesh of ``root.common.serving.mesh`` (None: one
        #: device)
        self.mesh = mesh_mod.serving_mesh_from_config()
        self._trainer = FusedTrainer(workflow, mesh=self.mesh)
        reason = self._trainer.uncaptured_reason
        if capture is None:
            capture = self.device.type == "cuda" and reason is None
        elif capture and self.device.type != "cuda":
            raise ValueError(f"ModelRunner(capture=True) captures CUDA "
                             f"graphs; this runner's device is "
                             f"{self.device}")
        elif capture and reason is not None:
            raise ValueError(f"ModelRunner(capture=True): {reason}")
        #: whether each rung is a captured CUDA graph
        self.capture = bool(capture)
        #: the served generation: read once a dispatch, flipped as one
        #: tuple by swap() and rollback()
        self._active = Generation(
            {f.name: {k: p.detach() for k, p in
                      FusedTrainer._params_of(f).items()}
             for f in self._trainer._weighted()}, 1, self._family())
        #: the snapshot the live generation came from ("" at random init)
        self.snapshot_path: str = snapshot or ""
        #: (generation, path) the last swap displaced: one rollback
        self._previous: Optional[Tuple[Generation, str]] = None
        #: generation high-water mark: a swap takes the next id, so a
        #: rolled-back and retried swap never reuses a stamp
        self._gen_hwm = 1
        self._swap_lock = threading.Lock()          # one swap at a time
        self._dispatch_lock = threading.Lock()      # one bound tree at a time
        #: True while swap() loads and warms
        self.swapping = False
        self.swaps = 0
        self.swap_failures = 0
        self.rollbacks = 0
        #: captures made (uncaptured: first dispatches of a shape), and
        #: their host seconds (the eager dispatch, the sync, the capture)
        self.compiles = 0
        self.capture_s = 0.0
        #: the compute-fault hook: a FaultSchedule, its cursor, the stalls
        self._chaos = None
        self._dispatch_no = 0
        self.stalls = 0
        #: per-sample input shape the service accepts
        self.sample_shape: Tuple[int, ...] = tuple(workflow.sample_shape)
        #: staging dtype (uint8 stays 1 byte on the wire; decoded on device)
        self.dtype = np.dtype(workflow.dtype)
        self._torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        #: forward dispatches since construction (or the last reset)
        self.dispatches = 0
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self._cuda and self.mesh is None else None)
        # the mesh's exchange
        self.rank = mesh_mod.process_index()
        self._dp = mesh_mod.axis_size(self.mesh, "data")
        self._pending: Optional[Tuple[Generation, str]] = None
        self._closed = False
        if self.mesh is not None:
            import torch.distributed as dist

            grid = self.mesh.mesh.cpu().numpy()
            axis = self.mesh.mesh_dim_names.index("data")
            #: each world rank's data coordinate
            self._coords = [0] * int(grid.size)
            for idx in np.ndindex(grid.shape):
                self._coords[int(grid[idx])] = idx[axis]
            self._wire = (torch.device("cpu")
                          if dist.get_backend() == "gloo" else self.device)

    def _family(self) -> Family:
        return Family(torch.cuda.graph_pool_handle() if self.capture
                      else None)

    # -- the mesh -------------------------------------------------------------

    @property
    def data_parallel(self) -> int:
        """The mesh's ``data`` axis size: every ladder rung is a multiple
        of it."""
        return self._dp

    @property
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """``{"data": dp, "model": mp}``, None on one device."""
        return mesh_mod.mesh_shape_dict(self.mesh)

    def _exchange(self, op: int = 0, rows: int = 0,
                  gen: int = 0) -> Tuple[int, int, int]:
        """Rank 0's header (op, rows, generation) on every rank."""
        import torch.distributed as dist

        hdr = torch.tensor([op, rows, gen], dtype=torch.int64,
                           device=self._wire)
        dist.broadcast(hdr, src=0)
        return tuple(int(v) for v in hdr.tolist())

    def _scatter(self, x: Optional[torch.Tensor], rows: int) -> torch.Tensor:
        """This rank's ``rows / dp`` rows of rank 0's host batch ``x``."""
        import torch.distributed as dist

        n = rows // self._dp
        out = torch.empty((n,) + self.sample_shape, dtype=self._torch_dtype,
                          device=self._wire)
        parts = None
        if self.rank == 0:
            parts = [x[d * n:(d + 1) * n].to(self._wire).contiguous()
                     for d in self._coords]
        mesh_mod._collective(lambda: dist.scatter(out, parts, src=0), out,
                             None)
        return out.to(self.device)

    def _gather(self, y: torch.Tensor) -> Optional[torch.Tensor]:
        """The ranks' rows of logits in data order on rank 0 (on the
        exchange's device); None elsewhere."""
        import torch.distributed as dist

        y = y.to(self._wire).contiguous()
        parts = ([torch.empty_like(y) for _ in self._coords]
                 if self.rank == 0 else None)
        mesh_mod._collective(lambda: dist.gather(y, parts, dst=0), y, None)
        if parts is None:
            return None
        first: Dict[int, int] = {}
        for r, d in enumerate(self._coords):
            first.setdefault(d, r)
        return torch.cat([parts[first[d]] for d in range(self._dp)])

    def _mesh_infer(self, g: Generation, x, rows: int) -> Optional[
            torch.Tensor]:
        """One meshed dispatch of ``rows`` rows on this rank (rank 0 holds
        the host batch ``x``); the caller holds the dispatch lock."""
        local = self._scatter(x, rows)
        y = self._forward(g, local, self._key((rows,) + self.sample_shape))
        return self._gather(y)

    def follow(self) -> None:
        """A rank other than 0 of a serving mesh: take rank 0's steps until
        it stops (``close()`` on rank 0)."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0 of "
                               "a serving mesh")
        while True:
            op, rows, gen = self._exchange()
            if op == STOP:
                return
            with self._dispatch_lock:
                if op == INFER:
                    g = self._active if gen else (
                        self._pending[0] if self._pending else None)
                    if g is None or g.gen != gen:
                        raise RuntimeError(
                            f"rank {self.rank}: rank 0 dispatched "
                            f"generation {gen}; this rank serves "
                            f"{self._active.gen}")
                    self._mesh_infer(g, None, rows)
                    self.dispatches += 1
                elif op == LOAD:
                    try:
                        self._load(mesh_mod.agree(None))
                    except RuntimeError:    # every rank raised: serve on
                        pass
                elif op == FLIP:
                    self._free(self._flip(gen))
                elif op == DROP:
                    self._free(self._drop())
                elif op == ROLLBACK:
                    self._free(self._roll_back()[1])
                else:
                    raise RuntimeError(f"rank {self.rank}: unknown step "
                                       f"{op} from rank 0")

    def close(self) -> None:
        """On rank 0 of a serving mesh, stop the other ranks' ``follow``
        (once); a no-op elsewhere."""
        if self.mesh is None or self.rank != 0 or self._closed:
            return
        with self._dispatch_lock:
            self._closed = True
            self._exchange(STOP)

    # -- the two halves of the ping-pong --------------------------------------

    def host_buffer(self, shape) -> torch.Tensor:
        """An uninitialised host tensor in the staging dtype to assemble a
        batch in: pinned when the device is a GPU, so :meth:`stage` copies
        it asynchronously."""
        return torch.empty(tuple(shape), dtype=self._torch_dtype,
                           pin_memory=self._cuda)

    def stage(self, x) -> Staged:
        """Host batch (numpy array or host tensor) -> device.  On a GPU the
        copy runs on a side stream from pinned memory and returns at once;
        a numpy batch or an unpinned tensor is first copied into a pinned
        buffer.  On a mesh the batch stays on the host (rank 0 scatters
        it) and must split evenly over ``data``."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, self.dtype))
        if x.dtype != self._torch_dtype:
            raise TypeError(f"staged batch is {x.dtype}, the service "
                            f"stages {self._torch_dtype}")
        if self.mesh is not None:
            mesh_mod.require_batch_divisible(x.shape[0], self.mesh)
            return Staged(x, None, None)
        if not self._cuda:
            return Staged(x, None, None)
        if not x.is_pinned():
            pinned = self.host_buffer(x.shape)
            pinned.copy_(x)
            x = pinned
        with torch.cuda.stream(self._copy_stream):
            x_dev = x.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return Staged(x_dev, event, x)

    @property
    def generation(self) -> int:
        """The generation the next dispatch serves."""
        return self._active.gen

    def _maybe_stall(self) -> None:
        """The compute-fault hook: one ``decide_compute`` decision a
        dispatch, the cursor advanced under the dispatch lock (a swap's
        warm dispatches race the compute thread); a stall sleeps here."""
        with self._dispatch_lock:
            no = self._dispatch_no
            self._dispatch_no += 1
            chaos = self._chaos
            if chaos is None:
                return
            action, seconds = chaos.decide_compute(no)
            if action == "stall":
                self.stalls += 1
        if action == "stall":
            time.sleep(seconds)

    def inject_compute_faults(self, schedule) -> None:
        """Arm the compute-fault hook with ``schedule`` (a chaos
        ``FaultSchedule``; None disarms it)."""
        self._chaos = schedule

    def infer_staged(self, staged: Staged,
                     generation: Optional[Generation] = None):
        """Dispatch the forward on a staged batch; returns ``(device
        result, generation id)``.  The result is not synchronised: reading
        it on the host is the sync point.  ``generation`` (a swap's warm)
        serves that generation instead of the live one, stamped 0."""
        self._maybe_stall()
        x = staged.x
        if staged.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.event)
            x.record_stream(compute)
        with self._dispatch_lock:
            g = self._active if generation is None else generation
            if self.mesh is None:
                y = self._forward(g, x, self._key(tuple(x.shape)))
            else:
                if self._closed:
                    raise RuntimeError("the serving mesh was closed")
                self._exchange(INFER, x.shape[0], g.gen)
                y = self._mesh_infer(g, x, x.shape[0])
            self.dispatches += 1
        return y, g.gen

    def _key(self, shape: Tuple[int, ...]) -> tuple:
        """A dispatch's family key: the global batch shape, the staging
        dtype and the engine knobs (they choose the kernel routing)."""
        eng = root.common.engine
        return (tuple(int(d) for d in shape), self.dtype.str,
                tuple(repr(eng.get(k, None)) for k in ENGINE_DEFAULTS))

    def _eager(self, g: Generation, x: torch.Tensor) -> torch.Tensor:
        with self._bound(g.tree), torch.inference_mode():
            return self._trainer.forward_pass(self._trainer._decode(x))

    def _forward(self, g: Generation, x: torch.Tensor,
                 key: tuple) -> torch.Tensor:
        """``g``'s forward of ``x`` (the caller holds the dispatch lock):
        a replay of the key's graph, else its capture."""
        graphs = g.family.graphs
        if not self.capture:
            y = self._eager(g, x)
            if key not in graphs:
                graphs[key] = None
                self.compiles += 1
            return y
        cap = graphs.get(key)
        if cap is None:
            return self._capture(g, x, key)
        with torch.inference_mode():
            cap.inputs["x"].copy_(x)
            cap.replay()
            return cap.outputs.clone()

    def _capture(self, g: Generation, x: torch.Tensor,
                 key: tuple) -> torch.Tensor:
        """The key's first dispatch: eager on the capture stream, then the
        device synchronised and the forward captured into ``g``'s family;
        returns the eager result."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        stream = capture_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            y = self._eager(g, x)
        current.wait_stream(stream)
        y.record_stream(current)
        torch.cuda.synchronize(self.device)
        cap = StepGraph({"x": torch.empty_like(x)}, None, {})
        with self._bound(g.tree), torch.inference_mode():
            cap.capture(lambda: self._trainer.forward_pass(
                self._trainer._decode(cap.inputs["x"])), stream,
                pool=g.family.pool)
        g.family.graphs[key] = cap
        self.compiles += 1
        self.capture_s += time.perf_counter() - t0
        return y

    def graph_cache_size(self) -> int:
        """The live generation's family size (the reference's
        ``jit_cache_size``): after warmup it equals ``compiles`` and the
        ladder's rung count."""
        return len(self._active.family)

    @contextlib.contextmanager
    def _bound(self, tree: Dict):
        """The modules read ``tree``'s tensors as their parameters within
        it (the caller holds the dispatch lock)."""
        saved = []
        try:
            for f in self._trainer._weighted():
                for k, t in tree[f.name].items():
                    saved.append((f, k, f._parameters[k]))
                    f._parameters[k] = t
            yield
        finally:
            for f, k, p in reversed(saved):
                f._parameters[k] = p

    # -- snapshot rollover ----------------------------------------------------

    def _load(self, path: str) -> Dict:
        """Load ``path`` into a pending generation (each rank's part of a
        split leaf); on a mesh every rank raises if any rank's load
        failed.  Returns the snapshot."""
        from znicz_torch import snapshotter

        snap = error = None
        try:
            snap = snapshotter.Snapshotter.load(path)
            params = snapshotter.inference_params(self.workflow, snap)
        except Exception as exc:
            error = exc
        if self.mesh is not None:
            mesh_mod.raise_anywhere(error, f"loading snapshot {path!r}")
        elif error is not None:
            raise error
        self._pending = (Generation(params, 0, self._family()), path)
        return snap

    def _flip(self, gen: int) -> List[Family]:
        """The pending generation served as ``gen``; the live one kept for
        a rollback.  Returns the families to free."""
        pending, path = self._pending
        self._pending = None
        dropped = [] if self._previous is None \
            else [self._previous[0].family]
        self._previous = (self._active, self.snapshot_path)
        self._active = pending._replace(gen=gen)
        self.snapshot_path = path
        return dropped

    def _drop(self) -> List[Family]:
        """The pending generation discarded (a failed warm)."""
        pending, self._pending = self._pending, None
        return [] if pending is None else [pending[0].family]

    def _roll_back(self) -> Tuple[int, List[Family]]:
        """The kept generation served again; returns its id and the
        families to free."""
        (g, path), self._previous = self._previous, None
        dropped = [self._active.family]
        self._active = g
        self.snapshot_path = path
        return g.gen, dropped

    def _free(self, families: List[Family]) -> None:
        """Free families no dispatch can reach any more, once the device
        has run what was queued."""
        if families and self.capture:
            torch.cuda.synchronize(self.device)
        for family in families:
            family.release()

    def swap(self, path: str, ladder=None) -> Dict:
        """Load the snapshot at ``path`` into a new parameter tree, warm it
        through every rung of ``ladder`` (capturing its family; each warm
        dispatch interleaves with served ones under the dispatch lock),
        then flip the served generation at once; served batches keep the
        old generation until the flip.  A concurrent swap, a snapshot that
        does not cover the model, or a failed warm raises and leaves the
        live generation serving (``swap_failures`` counts it).  Returns
        the snapshot's metadata.  On a mesh, rank 0 calls it and every
        rank takes its steps."""
        if not self._swap_lock.acquire(blocking=False):
            self.swap_failures += 1
            raise RuntimeError("swap already in progress")
        try:
            self.swapping = True
            try:
                if self.mesh is None:
                    snap = self._load(path)
                else:
                    with self._dispatch_lock:
                        self._exchange(LOAD)
                        snap = self._load(mesh_mod.agree(path))
                pending = self._pending[0]
                try:
                    for bucket in (ladder.buckets() if ladder is not None
                                   else ()):
                        x = np.zeros(self.bucket_shape(bucket), self.dtype)
                        y, _ = self.infer_staged(self.stage(x), pending)
                        y.cpu()
                except BaseException:
                    with self._dispatch_lock:
                        if self.mesh is not None:
                            self._exchange(DROP)
                        dropped = self._drop()
                    self._free(dropped)
                    raise
                with self._dispatch_lock:
                    self._gen_hwm += 1
                    if self.mesh is not None:
                        self._exchange(FLIP, 0, self._gen_hwm)
                    dropped = self._flip(self._gen_hwm)
                self._free(dropped)
                self.swaps += 1
                return {k: v for k, v in snap.items()
                        if k not in ("units", "velocities")}
            except Exception:
                self.swap_failures += 1
                raise
        finally:
            self.swapping = False
            self._swap_lock.release()

    def rollback(self) -> int:
        """Serve again the generation the last :meth:`swap` displaced, its
        stamp and its family included, with no disk read and no capture;
        once.  Raises ``RuntimeError`` when nothing is kept or a swap is
        under way (the live generation serving on).  Returns the
        generation."""
        if not self._swap_lock.acquire(blocking=False):
            raise RuntimeError("swap in progress: rollback refused")
        try:
            if self._previous is None:
                raise RuntimeError("no previous generation kept (nothing "
                                   "was swapped, or it was rolled back)")
            with self._dispatch_lock:
                if self.mesh is not None:
                    self._exchange(ROLLBACK)
                gen, dropped = self._roll_back()
            self._free(dropped)
            self.rollbacks += 1
            return gen
        finally:
            self._swap_lock.release()

    def stats(self) -> Dict:
        return {"generation": self.generation, "swapping": self.swapping,
                "snapshot_path": self.snapshot_path,
                "swaps": self.swaps, "swap_failures": self.swap_failures,
                "rollbacks": self.rollbacks, "dispatches": self.dispatches,
                "capture": self.capture, "compiles": self.compiles,
                "graph_cache_size": self.graph_cache_size(),
                "capture_s": self.capture_s, "stalls": self.stalls,
                "mesh": self.mesh_shape}

    # -- conveniences ---------------------------------------------------------

    def infer(self, x) -> np.ndarray:
        """Synchronous forward of one host batch."""
        y, _ = self.infer_staged(self.stage(x))
        return y.cpu().numpy()

    def pad(self, x: np.ndarray, bucket: int) -> np.ndarray:
        """Zero-pad a (n, *sample) batch up to ``bucket`` rows.  The
        forward is row-independent, so pad rows cannot perturb real rows;
        the caller slices the first n output rows back out."""
        n = x.shape[0]
        if n == bucket:
            return x
        out = np.zeros((bucket,) + tuple(x.shape[1:]), self.dtype)
        out[:n] = x
        return out

    def bucket_shape(self, bucket: int) -> Tuple[int, ...]:
        return (int(bucket),) + self.sample_shape

    def warmup(self, ladder) -> int:
        """Run every ladder rung once (its capture, cuDNN's algorithm
        choice, the kernel builds and allocator growth happen here, not
        under traffic); returns ``compiles`` afterwards."""
        for bucket in ladder.buckets():
            self.infer(np.zeros(self.bucket_shape(bucket), self.dtype))
        return self.compiles
