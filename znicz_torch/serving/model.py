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
``warmup(ladder)`` both equal ``len(ladder.buckets())`` (the rungs, or on
a 2-D ladder every (rows, seq) bucket, each one graph), and traffic adds
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
count in ``stats()["stalls"]`` and in the ``chaos`` scope's ``faults``
series (``direction="compute"``, ``action="stall"``).

**Telemetry.**  The runner's counters (``compiles``, ``swaps``,
``swap_failures``, ``rollbacks``, ``stage_copies``) are registry counters
of the ``model`` scope, read through properties of the same names, with
the ``generation``, ``mesh_devices`` and ``jit_cache_size`` (the live
family's size) gauges; the prefix cache's are the ``prefix_cache``
scope's, and an eviction is a ``prefix_evict`` journal event.  Nothing
is observed inside a captured forward: a replay runs no Python.

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

**The build cache** (:meth:`ModelRunner.enable_aot_cache`,
``serving/aot_cache.py``): the kernel libraries the forward launches are
loaded from a cache next to the snapshot instead of built, and each rung
is captured again at every boot (a graph cannot be written to disk).
:meth:`ModelRunner.warm_proof` is the boot's proof, which the frontend
gates readiness on in cache mode.

**Generation** (:meth:`ModelRunner.enable_generation`,
:class:`GenerationRunner`): prefill and decode over a block-paged KV pool
with prefix reuse and in-graph sampling.  Its executables are graphs of
the live generation's family beside the ladder rungs, keyed
``("prefill", rows, pages)``, ``("decode", rows, pages)`` and
``("copy",)``; a swap captures them again for the new tree (the
reference's jit executables take the parameters as arguments, so its
swap recompiles nothing).

**Sequences** (a 2-D ladder): a bucket ``(rows, seq)`` is staged as
``(rows, seq, *sample[1:])`` (:meth:`ModelRunner.bucket_shape`); the
sequence modules take their positions and causal masks from the input's
own length, so each bucket is one shape, one key and one graph.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from znicz_torch import telemetry
from znicz_torch.attention import (CharEmbedding, MultiHeadAttention,
                                   SeqAll2All, SeqAll2AllSoftmax)
from znicz_torch.core.config import ENGINE_DEFAULTS, root
from znicz_torch.dropout import DropoutForward
from znicz_torch.ops.attention import paged_gather
from znicz_torch.ops.linear import seq_linear
from znicz_torch.parallel import mesh as mesh_mod
from znicz_torch.parallel.fused import FusedTrainer
from znicz_torch.parallel.graphs import StepGraph, capturing
from znicz_torch.telemetry.metrics import registered_property


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

    #: the runner's registry counters (``model`` scope): name -> HELP
    COUNTERS = {
        "compiles": "captures of the served forward == family entries",
        "swaps": "completed snapshot rollovers",
        "swap_failures": "rollovers refused/failed (old generation kept "
                         "serving)",
        "rollbacks": "retained-previous generation restored (fleet canary "
                     "auto-rollback path)",
        "stage_copies": "host batches copied before staging (unpinned or "
                        "wrong-dtype input; the frontend's assemble path "
                        "never pays this)",
    }

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
        _sc = telemetry.scope("model")
        #: the registry counters behind the properties of the same names;
        #: ``compiles`` counts captures (uncaptured: first dispatches of
        #: a shape)
        self._m = {name: _sc.counter(name, help)
                   for name, help in self.COUNTERS.items()}
        _sc.gauge("generation", "live snapshot generation id",
                  fn=telemetry.weak_fn(self, lambda r: r.generation))
        _sc.gauge("mesh_devices", "devices in the serving mesh (1 = "
                  "single-device)",
                  fn=telemetry.weak_fn(self, lambda r: r.device_count))
        _sc.gauge("jit_cache_size", "captured rungs of the live "
                  "generation's family",
                  fn=telemetry.weak_fn(self,
                                       lambda r: r.graph_cache_size()))
        self._m_stalls = None
        self._tracer = telemetry.tracer()
        #: the captures' host seconds (the eager dispatch, the sync, the
        #: capture)
        self.capture_s = 0.0
        #: the compute-fault hook: a FaultSchedule, its cursor, the stalls
        self._chaos = None
        self._dispatch_no = 0
        self.stalls = 0
        #: the armed build cache (None: off), and the kernel libraries
        #: the warmup asked for, each with where the process got it
        self._aot_cache = None
        self.kernels: Dict[str, str] = {}
        self._warm = {"hits": 0, "misses": 0}
        #: the generation plane (enable_generation), None until enabled
        self.gen_runner: Optional["GenerationRunner"] = None
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

    @property
    def device_count(self) -> int:
        """The ranks serving (dp x mp on a mesh, else 1): the capacity the
        heartbeat advertises."""
        shape = self.mesh_shape
        return int(np.prod(list(shape.values()))) if shape else 1

    def _exchange(self, op: int = 0, rows: int = 0, gen: int = 0,
                  seq: int = 0) -> Tuple[int, int, int, int]:
        """Rank 0's header (op, rows, generation, seq) on every rank; seq
        is a 2-D bucket's sequence rung, 0 for a batch of whole
        samples."""
        import torch.distributed as dist

        hdr = torch.tensor([op, rows, gen, seq], dtype=torch.int64,
                           device=self._wire)
        dist.broadcast(hdr, src=0)
        return tuple(int(v) for v in hdr.tolist())

    def _row_shape(self, seq: int) -> Tuple[int, ...]:
        """One row's shape: the sample's, or ``(seq, *sample[1:])``."""
        return (seq,) + self.sample_shape[1:] if seq else self.sample_shape

    def _seq_of(self, x) -> int:
        """The seq rung of a staged batch: 0 when its rows are whole
        samples."""
        return 0 if tuple(x.shape[1:]) == self.sample_shape \
            else int(x.shape[1])

    def _scatter(self, x: Optional[torch.Tensor], rows: int,
                 seq: int = 0) -> torch.Tensor:
        """This rank's ``rows / dp`` rows of rank 0's host batch ``x``."""
        import torch.distributed as dist

        n = rows // self._dp
        out = torch.empty((n,) + self._row_shape(seq),
                          dtype=self._torch_dtype, device=self._wire)
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

    def _mesh_infer(self, g: Generation, x, rows: int,
                    seq: int = 0) -> Optional[torch.Tensor]:
        """One meshed dispatch of ``rows`` rows on this rank (rank 0 holds
        the host batch ``x``); the caller holds the dispatch lock."""
        local = self._scatter(x, rows, seq)
        y = self._forward(g, local, self._key((rows,) + self._row_shape(seq)))
        return self._gather(y)

    def follow(self) -> None:
        """A rank other than 0 of a serving mesh: take rank 0's steps until
        it stops (``close()`` on rank 0)."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0 of "
                               "a serving mesh")
        while True:
            op, rows, gen, seq = self._exchange()
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
                    self._mesh_infer(g, None, rows, seq)
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
            dp = mesh_mod.require_batch_divisible(x.shape[0], self.mesh)
            # the rows stay on the host: rank 0 scatters each data
            # coordinate its shard at the dispatch
            self._tracer.instant("model", "stage_sharded",
                                 rows=int(x.shape[0]), shards=dp,
                                 rows_per_shard=int(x.shape[0]) // dp)
            return Staged(x, None, None)
        if not self._cuda:
            return Staged(x, None, None)
        if not x.is_pinned():
            self._m["stage_copies"].inc()
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
                self._m_stalls.inc()
        if action == "stall":
            time.sleep(seconds)

    def inject_compute_faults(self, schedule) -> None:
        """Arm the compute-fault hook with ``schedule`` (a chaos
        ``FaultSchedule``; None disarms it); stalls count in the chaos
        fault family, like the proxy's wire faults."""
        if self._m_stalls is None:
            self._m_stalls = telemetry.scope("chaos").counter(
                "faults", "injected proxy fault decisions",
                direction="compute", action="stall")
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
                seq = self._seq_of(x)
                self._exchange(INFER, x.shape[0], g.gen, seq)
                y = self._mesh_infer(g, x, x.shape[0], seq)
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
                self._m["compiles"].inc()
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
        with capturing(self.device) as stream:
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
        self._m["compiles"].inc()
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
            self._m["swap_failures"].inc()
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
                    if self.gen_runner is not None:
                        # the new tree's generation graphs, beside its
                        # rungs; the pools stay where they are
                        self.gen_runner.warmup(pending)
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
                self._m["swaps"].inc()
                return {k: v for k, v in snap.items()
                        if k not in ("units", "velocities")}
            except Exception:
                self._m["swap_failures"].inc()
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
            self._m["rollbacks"].inc()
            return gen
        finally:
            self._swap_lock.release()

    def enable_generation(self, page_size: int, num_pages: int,
                          slots: int, prefill_chunk: int,
                          prefix_cache: bool = True,
                          prefill_rungs=None, decode_rungs=None
                          ) -> "GenerationRunner":
        """Build the generation plane (:class:`GenerationRunner`: the paged
        KV pool, the prefix cache, the prefill, decode and copy
        executables over this runner's live tree).  Idempotent; returns
        the :class:`GenerationRunner`."""
        if self.gen_runner is None:
            self.gen_runner = GenerationRunner(
                self, page_size=page_size, num_pages=num_pages,
                slots=slots, prefill_chunk=prefill_chunk,
                prefix_cache=prefix_cache, prefill_rungs=prefill_rungs,
                decode_rungs=decode_rungs)
        return self.gen_runner

    # -- the build cache ------------------------------------------------------

    def enable_aot_cache(self, directory: str = "") -> bool:
        """Arm the build cache (``serving/aot_cache.py``) for this process
        before the warmup: a kernel library the forward asks for is
        loaded from it where it holds one, and one built is stored in it.
        ``directory`` defaults to ``aot_cache/`` next to this runner's
        snapshot.  Returns True (the cache is always available)."""
        from znicz_torch import _build
        from znicz_torch.serving import aot_cache

        if not directory:
            if not self.snapshot_path:
                raise ValueError(
                    "enable_aot_cache needs an explicit directory when the "
                    "runner was not booted from a snapshot")
            directory = aot_cache.dir_for_snapshot(self.snapshot_path)
        self._aot_cache = aot_cache.ExecutableCache(
            directory, aot_cache.family_key(self))
        _build.set_library_cache(self._aot_cache)
        return True

    @property
    def aot_enabled(self) -> bool:
        return self._aot_cache is not None

    def _settle_kernels(self, before: Dict[str, int]) -> None:
        """Count the libraries the warmup asked for (``_build.touched``
        rose since ``before``) by where the process got them, and store
        each that did not come from the cache."""
        from znicz_torch import _build

        cache = self._aot_cache
        for name in sorted(_build.touched):
            if _build.touched[name] <= before.get(name, 0) \
                    or name in self.kernels:
                continue
            origin = _build.origins.get(name, "disk")
            self.kernels[name] = origin
            hit = origin == "cache"
            self._warm["hits" if hit else "misses"] += 1
            if cache is None:
                continue
            if hit:
                cache.hit()
            else:
                cache.miss()
                if not cache.holds(_build.library_entry(name)):
                    cache.keep(name, _build._target(name))

    @property
    def warm_source(self) -> Optional[str]:
        """Where this boot's kernel libraries came from: ``cache_hit``
        (all from the cache), ``compiled`` (none; or no library but rungs
        captured), ``mixed``, or None before any warmup."""
        h, m = self._warm["hits"], self._warm["misses"]
        if h and m:
            return "mixed"
        if h:
            return "cache_hit"
        if m or self.compiles:
            return "compiled"
        return None

    def warm_proof(self, expected: int) -> Dict:
        """The boot's proof of a whole family (the reference's): every
        rung captured once, none since (``compiles ==
        graph_cache_size() == expected``).  In cache mode also: every
        kernel library the warmup asked for is in the cache (loaded from
        it, or built and stored), and ``nvcc`` ran only for the libraries
        it missed.  A boot that hit everything shows ``warm_source ==
        "cache_hit"`` and ``nvcc_runs == 0``."""
        from znicz_torch import _build

        graphs = self.graph_cache_size()
        ok = self.compiles == int(expected) == graphs
        cache = self._aot_cache
        if cache is not None:
            built = sum(1 for o in self.kernels.values() if o == "nvcc")
            ok = ok and _build.nvcc_runs <= built and all(
                cache.holds(_build.library_entry(n)) for n in self.kernels)
        return {"mode": "aot" if cache is not None else "jit",
                "expected": int(expected), "compiles": int(self.compiles),
                "graph_cache_size": int(graphs),
                "kernels": dict(self.kernels),
                "nvcc_runs": int(_build.nvcc_runs),
                "cache_hits": int(self._warm["hits"]),
                "cache_misses": int(self._warm["misses"]),
                "cache_refusals": int(cache.counts["refusals"])
                if cache is not None else 0,
                "warm_source": self.warm_source, "ok": bool(ok)}

    def stats(self) -> Dict:
        return {"aot_enabled": self.aot_enabled,
                "warm_source": self.warm_source,
                "warm_hits": int(self._warm["hits"]),
                "warm_misses": int(self._warm["misses"]),
                "kernels": dict(self.kernels),
                "generation": self.generation, "swapping": self.swapping,
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

    def bucket_shape(self, bucket) -> Tuple[int, ...]:
        """The staged input shape of a ladder bucket: ``(rung, *sample)``,
        or ``(rows, seq, *sample[1:])`` for a 2-D ``(rows, seq)`` bucket
        (the seq axis takes the trained length's place)."""
        if isinstance(bucket, tuple):
            rows, seq = bucket
            return (int(rows), int(seq)) + self.sample_shape[1:]
        return (int(bucket),) + self.sample_shape

    def warmup(self, ladder) -> int:
        """Run every ladder rung once (its capture, cuDNN's algorithm
        choice, the kernel builds or cache loads and allocator growth
        happen here, not under traffic); returns ``compiles``
        afterwards."""
        from znicz_torch import _build

        before = dict(_build.touched)
        for bucket in ladder.buckets():
            self.infer(np.zeros(self.bucket_shape(bucket), self.dtype))
        self._settle_kernels(before)
        return self.compiles


for _name, _help in ModelRunner.COUNTERS.items():
    setattr(ModelRunner, _name, registered_property(_name, _help))
del _name, _help


# -- generation ---------------------------------------------------------------


def batch_rungs(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two batch rungs up to and including ``max_batch``: the
    default prefill and decode coalescing ladder."""
    n = int(max_batch)
    rungs = []
    r = 1
    while r < n:
        rungs.append(r)
        r *= 2
    rungs.append(n)
    return tuple(rungs)


def _sample_tokens(logits, temp, top_k, seeds, t):
    """In-graph sampling: greedy argmax where ``temp <= 0`` (a tie goes to
    the lowest id, as the host sampler's), else the seeded gumbel-max over
    the optional per-row top-k cut.  ``seeds`` and ``t`` are (b,) int64
    holding uint32 values; row ``i``'s noise is
    ``gumbel(fold_in(seed_i, t_i))`` (``ops/random.py``), a function of
    its own request's seed and position only.  Returns ((b,) int64
    tokens, (b,) float32 log-probabilities of them under the raw
    logits)."""
    from znicz_torch.ops import random as rnd

    b, v = logits.shape
    logits = logits.to(torch.float32)
    rows = torch.arange(b, device=logits.device)
    greedy = torch.argmax(logits, dim=-1)
    z = logits / torch.clamp_min(temp, 1e-20)[:, None]
    srt = torch.sort(z, dim=-1).values                  # ascending
    kk = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    kth = srt[rows, v - kk]                             # k-th largest
    z = torch.where(z < kth[:, None], -torch.inf, z)
    noise = rnd.gumbel(rnd.fold_in(seeds, t), v)
    sampled = torch.argmax(z + noise, dim=-1)
    tok = torch.where(temp > 0, sampled, greedy)
    logp = torch.log_softmax(logits, dim=-1)[rows, tok]
    return tok, logp


#: the prefix cache's counters: name -> meaning
PREFIX_COUNTERS = {
    "hits": "prompt prefix lookups that matched (>= 1 full page shared)",
    "misses": "prompt prefix lookups that matched nothing",
    "evictions": "indexed prefix pages evicted under allocation pressure "
                 "(LRU, idle entries only)",
    "tokens_avoided": "prompt tokens not prefilled thanks to prefix-page "
                      "hits",
    "flops_avoided": "prefill flops avoided by prefix reuse "
                     "(tokens_avoided x ~2 flops a weight)",
}


class PrefixCache:
    """A content-addressed index of full KV pages.

    Page ``i`` of a prompt is keyed by a chain hash of (the hash of pages
    ``[0, i)``, its own tokens), so a lookup matches a page only when its
    whole preceding context matches too.  The index holds one reference
    on every page it lists; a request that hits shares the page read-only
    (one more reference), and its first divergent append copies the page
    (the scheduler's copy-on-write, :meth:`GenerationRunner.copy_page`).
    Eviction takes the least recently used entry only the index holds
    (refcount 1), and only when the pool runs dry.

    With ``prefill_chunk == page_size`` a hit replays the same prefill
    grid a cold prompt runs (registration indexes only pages computed on
    that grid: a copied page's hash is already indexed), so a hit decodes
    bit-identically to a cold prefill."""

    def __init__(self, gen: "GenerationRunner"):
        import collections

        self.gen = gen
        #: chain hash -> page id, least recently used first
        self._index: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._by_page: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._index)

    def _hashes(self, prompt) -> List[bytes]:
        """Chain hashes of every full page of ``prompt``."""
        import hashlib

        ps = self.gen.page_size
        out = []
        h = b"znicz-prefix-v1"
        for i in range(len(prompt) // ps):
            h = hashlib.blake2b(
                h + np.asarray(prompt[i * ps:(i + 1) * ps],
                               np.int32).tobytes(),
                digest_size=16).digest()
            out.append(h)
        return out

    def lookup(self, prompt) -> Tuple[List[int], int]:
        """Claim the longest indexed run of ``prompt``'s full pages:
        ``(pages, covered tokens)``, one reference taken on each page for
        the request (dropped by ``release_pages``)."""
        pages = []
        for h in self._hashes(prompt):
            page = self._index.get(h)
            if page is None:
                break
            self._index.move_to_end(h)
            self.gen.addref(page)
            pages.append(page)
        covered = len(pages) * self.gen.page_size
        if pages:
            self.gen._count("hits")
            self.gen._count("tokens_avoided", covered)
            self.gen._count("flops_avoided",
                            covered * self.gen.flops_per_token)
        else:
            self.gen._count("misses")
        return pages, covered

    def register(self, prompt, pages) -> None:
        """Index ``prompt``'s full pages once its prefill completed: a
        hash already indexed keeps its page (the first writer wins), a
        new one takes an index-owned reference on the request's page."""
        for i, h in enumerate(self._hashes(prompt)):
            if h in self._index or pages[i] in self._by_page:
                continue
            self.gen.addref(pages[i])
            self._index[h] = pages[i]
            self._by_page[pages[i]] = h

    def evict_one(self) -> bool:
        """Drop the least recently used entry whose page only the index
        holds, freeing exactly one page; False when every indexed page is
        shared with a live request.  Each eviction is a ``prefix_evict``
        journal event with the pressure numbers."""
        for h, page in self._index.items():
            if self.gen.page_ref[page] == 1:
                del self._index[h]
                del self._by_page[page]
                self.gen.decref(page)
                self.gen._count("evictions")
                telemetry.emit(
                    "prefix_evict", "serving", page=int(page),
                    indexed=len(self._index),
                    kv_occupancy=round(self.gen.occupancy(), 4))
                return True
        return False


class GenerationRunner:
    """The generation plane of a :class:`ModelRunner`: block-paged KV
    cache, prefix reuse, chunked prefill, decode and in-graph sampling.

    **The pool**: per attention layer one ``(num_pages + 1, page_size,
    heads, head_dim)`` float32 tensor for keys and one for values, made
    once on the runner's device and written in place, never reallocated.
    Page ``num_pages`` is scratch: pad rows read and write it, so a pad
    row never touches a real page.  A request's cache is a host list of
    pages; a dispatch carries it as a (rows, P) page table padded to a
    power-of-two page rung ``P``.

    **Executables** (each one graph of the live generation's family, its
    first dispatch eager, as a ladder rung's):

      - prefill, one a (prefill rung x page rung): one ``prefill_chunk``
        token chunk a row at per-row offsets ``t0`` through the stack
        (``apply_offset``, ``apply_prefill_chunk`` over the gathered
        pages, the position-wise layers, the head); the chunk's keys and
        values go into the pool in place at ``(table[i, (t0 + j) //
        page_size], (t0 + j) % page_size)``, pad tokens to scratch; each
        row's logits at ``n_new - 1`` are sampled at ``t0 + n_new - 1``;
      - decode, one a (decode rung x page rung): ``apply_decode`` of each
        row's token at its own depth ``t``, its key and value appended in
        place, sampled at ``t``;
      - copy: one whole page from ``src`` to ``dst`` across every layer
        (the copy-on-write move).

    Each returns ``(tokens, logprobs, logits)``; the inputs are two
    packed buffers (the integers: page table, tokens, offsets, top-k,
    seeds; the floats: temperatures) copied into the graph's static
    buffers before each replay.  Sampling lives in the executables, so
    the scheduler fetches (b,) tokens a tick instead of (b, vocab)
    logits when ``on_device_sampling`` is on.

    One device only (a serving mesh refuses generation).  The page
    bookkeeping belongs to the compute thread; dispatches take the
    runner's dispatch lock, as its forwards do."""

    def __init__(self, runner: ModelRunner, page_size: int,
                 num_pages: int, slots: int, prefill_chunk: int,
                 prefix_cache: bool = True, prefill_rungs=None,
                 decode_rungs=None):
        if runner.mesh is not None:
            raise ValueError(
                "generation serving is single-device for now (the KV-cache "
                "pool does not shard); drop root.common.serving.mesh for "
                "this replica")
        self.runner = runner
        forwards = runner.workflow.forwards
        if not forwards or not isinstance(forwards[0], CharEmbedding):
            raise ValueError(
                "generation serving needs a CharEmbedding first unit "
                "(token ids in, one position per token)")
        last = forwards[-1]
        if not isinstance(last, SeqAll2AllSoftmax):
            raise ValueError(
                "generation serving needs a per-position softmax head "
                "(SeqAll2AllSoftmax) as the last unit")
        self._attn = []
        for f in forwards[1:-1]:
            if isinstance(f, MultiHeadAttention):
                if not f.causal:
                    raise ValueError(
                        f"{f.name}: generation requires causal attention "
                        f"(a KV cache IS the causal prefix)")
                self._attn.append(f)
            elif not isinstance(f, (SeqAll2All, DropoutForward)):
                raise ValueError(
                    f"{f.name}: unit {type(f).__name__} has no decode form "
                    f"— generation serves CharEmbedding + causal "
                    f"MultiHeadAttention + SeqAll2All* stacks")
        if not self._attn:
            raise ValueError("generation serving needs at least one "
                             "MultiHeadAttention unit (nothing to cache)")
        self._forwards = forwards
        self.max_len = int(forwards[0].max_len)
        self.page_size = int(page_size)
        if self.page_size < 2:
            raise ValueError(f"page_size must be >= 2, got {page_size}")
        self.num_pages = int(num_pages)
        pages_per_seq = -(-self.max_len // self.page_size)
        if self.num_pages < pages_per_seq:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one full context "
                f"window ({pages_per_seq} pages of {self.page_size} for "
                f"max_len={self.max_len})")
        #: the pad rows' page, never allocated
        self.scratch = self.num_pages
        rungs = []
        r = 1
        while r < pages_per_seq:
            rungs.append(r)
            r *= 2
        rungs.append(r)
        #: page-table width rungs: powers of two up to a full context's
        #: page count, the executables' second axis
        self.page_rungs = tuple(rungs)
        #: positions [0, max_ctx) are the most one request (prompt and
        #: generated tokens) may occupy
        self.max_ctx = self.max_len
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("generation needs >= 1 concurrency slot")
        self.prefill_rungs = tuple(prefill_rungs) if prefill_rungs \
            else batch_rungs(4)
        self.decode_rungs = tuple(decode_rungs) if decode_rungs \
            else batch_rungs(self.slots)
        shape = (self.num_pages + 1, self.page_size)
        dev = runner.device
        #: the pool: {layer: (num_pages + 1, page_size, heads, head_dim)},
        #: keys and values
        self.pk = {f.name: torch.zeros(shape + (f.heads, f.head_dim),
                                       dtype=torch.float32, device=dev)
                   for f in self._attn}
        self.pv = {f.name: torch.zeros(shape + (f.heads, f.head_dim),
                                       dtype=torch.float32, device=dev)
                   for f in self._attn}
        #: the host page allocator (compute thread only): a free stack and
        #: a refcount a page
        self._free_pages = list(range(self.num_pages))
        self.page_ref = np.zeros(self.num_pages, np.int32)
        #: ~2 flops a weight a token: the flops_avoided counter's rate
        self.flops_per_token = 2 * sum(
            int(p.numel()) for f in forwards
            for p in FusedTrainer._params_of(f).values())
        _pc = telemetry.scope("prefix_cache")
        self._pm = {name: _pc.counter(name, help)
                    for name, help in PREFIX_COUNTERS.items()}
        _pc.gauge("indexed_pages", "pages held by the prefix index",
                  fn=telemetry.weak_fn(
                      self, lambda s: float(len(s.prefix))
                      if s.prefix is not None else 0.0))
        _pc.gauge("shared_pages", "pages referenced by > 1 holder",
                  fn=telemetry.weak_fn(
                      self, lambda s: float((s.page_ref > 1).sum())))
        _pc.gauge("page_occupancy", "allocated pages / pool pages",
                  fn=telemetry.weak_fn(self, lambda s: s.occupancy()))
        self.prefix = PrefixCache(self) if prefix_cache else None

    # -- counters -------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self._pm[name].inc(int(n))

    def prefix_counts(self) -> Dict[str, int]:
        """The :data:`PREFIX_COUNTERS` by name."""
        return {name: m.value for name, m in self._pm.items()}

    # -- page bookkeeping (compute thread only) --------------------------------

    def _page_rung(self, n_pages: int) -> int:
        """The smallest page rung holding ``n_pages`` pages."""
        for r in self.page_rungs:
            if r >= n_pages:
                return r
        raise ValueError(
            f"{n_pages} pages exceed the top rung {self.page_rungs[-1]} — "
            f"the context window bounds this")

    def alloc_page(self) -> Optional[int]:
        """Claim one free page (refcount 1); under pressure evict an idle
        prefix page first; None when every page is held by a live request
        (the scheduler stalls that row a tick)."""
        if not self._free_pages and self.prefix is not None:
            self.prefix.evict_one()
        if not self._free_pages:
            return None
        page = self._free_pages.pop()
        self.page_ref[page] = 1
        return page

    def addref(self, page: int) -> None:
        """One more holder of a shared (read-only) page."""
        self.page_ref[page] += 1

    def decref(self, page: int) -> None:
        """Drop one reference; the page frees at zero."""
        self.page_ref[page] -= 1
        assert self.page_ref[page] >= 0, f"page {page} over-released"
        if self.page_ref[page] == 0:
            self._free_pages.append(page)

    def release_pages(self, pages) -> None:
        """Return a finished or failed request's references at once:
        pages the index or other requests share survive on their
        references, private ones are free this very tick."""
        for page in pages:
            self.decref(page)

    def pages_active(self) -> int:
        return self.num_pages - len(self._free_pages)

    def pages_leaked(self) -> int:
        """The invariant probe (must be 0): pages neither free nor
        referenced are lost to the allocator."""
        return int(self.num_pages - len(self._free_pages)
                   - int((self.page_ref > 0).sum()))

    def occupancy(self) -> float:
        """Allocated pages over pool pages, the KV-pool pressure gauge."""
        return self.pages_active() / float(self.num_pages)

    # -- the executables --------------------------------------------------------

    def _stack(self, toks, t, gathered, attend):
        """The forward of every layer after the embedding ``toks`` at
        offsets ``t``: each attention layer through ``attend(f, h, k, v,
        t)`` over its gathered pages; the new rows by layer."""
        last = self._forwards[-1]
        h = toks
        rows = {}
        for f in self._forwards[1:]:
            if isinstance(f, MultiHeadAttention):
                k, v = gathered(f.name)
                h, k_rows, v_rows = attend(f, h, k, v, t)
                rows[f.name] = (k_rows, v_rows)
            elif f is last:
                h = seq_linear(h, f.weights, f.bias,
                               weights_transposed=f.weights_transposed)
            elif not isinstance(f, DropoutForward):     # eval: identity
                h = f(h)
        return h, rows

    def _gathered(self, table):
        return lambda name: (paged_gather(self.pk[name], table),
                             paged_gather(self.pv[name], table))

    def _tokens(self, ids) -> torch.Tensor:
        """Token ids (int64) as the model's input: the staging dtype,
        decoded."""
        return self.runner._trainer._decode(
            ids.to(self.runner._torch_dtype))

    def _prefill_body(self, b: int, width: int, ints, temp):
        c, ps = self.prefill_chunk, self.page_size
        table, x, t0, n_new, top_k, seeds = torch.split(
            ints, [b * width, b * c, b, b, b, b])
        table, x = table.view(b, width), x.view(b, c)
        dev = ints.device
        h = self._forwards[0].apply_offset(self._tokens(x), t0)
        h, rows = self._stack(
            h, t0, self._gathered(table),
            lambda f, h, k, v, t: f.apply_prefill_chunk(h, k, v, t))
        ar = torch.arange(b, device=dev)
        logits = h[ar, n_new - 1]
        # token j of row i lands on page table[i, (t0 + j) // ps] at
        # offset (t0 + j) % ps; pad tokens (j >= n_new) on scratch
        j = torch.arange(c, device=dev)
        pos = t0[:, None] + j
        page = table[ar[:, None], torch.clamp(pos // ps, 0, width - 1)]
        page = torch.where(j[None, :] < n_new[:, None], page, self.scratch)
        off = pos % ps
        for name, (k_rows, v_rows) in rows.items():
            self.pk[name].index_put_((page, off), k_rows)
            self.pv[name].index_put_((page, off), v_rows)
        tok, logp = _sample_tokens(logits, temp, top_k, seeds,
                                   t0 + n_new - 1)
        return tok, logp, logits

    def _decode_body(self, b: int, width: int, ints, temp):
        ps = self.page_size
        table, tokens, t, top_k, seeds = torch.split(
            ints, [b * width, b, b, b, b])
        table = table.view(b, width)
        h = self._forwards[0].apply_decode(self._tokens(tokens), t)
        h, rows = self._stack(
            h, t, self._gathered(table),
            lambda f, h, k, v, t: f.apply_decode(h, k, v, t))
        logits = h[:, 0]
        ar = torch.arange(b, device=ints.device)
        page = table[ar, torch.clamp(t // ps, 0, width - 1)]
        for name, (k_row, v_row) in rows.items():
            self.pk[name].index_put_((page, t % ps), k_row)
            self.pv[name].index_put_((page, t % ps), v_row)
        tok, logp = _sample_tokens(logits, temp, top_k, seeds, t)
        return tok, logp, logits

    def _copy_body(self, ints, temp):
        src, dst = ints[0:1], ints[1:2]
        for pool in (*self.pk.values(), *self.pv.values()):
            pool.index_copy_(0, dst, pool.index_select(0, src))
        return ()

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        """A packed input on the host: pinned on a GPU, so its copy to the
        device does not wait on the host."""
        t = torch.from_numpy(arr)
        if not self.runner._cuda:
            return t
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned

    def _dispatch(self, key: tuple, ints: np.ndarray, temp: np.ndarray,
                  generation: Optional[Generation] = None):
        """One generation dispatch of ``key`` on the live generation (or
        ``generation``, a swap's warm): a replay of the key's graph, else
        its capture (eager on the first dispatch, as a ladder rung's).
        Returns (the outputs on the device, generation id)."""
        r = self.runner
        kind = key[0]
        if kind == "copy":
            body = self._copy_body
        else:
            fn = self._prefill_body if kind == "prefill" else \
                self._decode_body

            def body(i, f, fn=fn, b=key[1], width=key[2]):
                return fn(b, width, i, f)
        r._maybe_stall()
        ints_h, temp_h = self._host(ints), self._host(temp)
        with r._dispatch_lock:
            g = r._active if generation is None else generation
            graphs = g.family.graphs
            if not r.capture:
                with r._bound(g.tree), torch.inference_mode():
                    out = body(ints_h.to(r.device, non_blocking=True),
                               temp_h.to(r.device, non_blocking=True))
                if key not in graphs:
                    graphs[key] = None
                    r.compiles += 1
                return out, g.gen
            cap = graphs.get(key)
            if cap is None:
                return self._capture(g, key, body, ints_h, temp_h), g.gen
            with torch.inference_mode():
                cap.inputs["ints"].copy_(ints_h, non_blocking=True)
                cap.inputs["temp"].copy_(temp_h, non_blocking=True)
                cap.replay()
                return tuple(o.clone() for o in cap.outputs), g.gen

    def _capture(self, g: Generation, key: tuple, body, ints_h, temp_h):
        """``key``'s first dispatch: eager on the capture stream from the
        graph's static inputs, then the device synchronised and the body
        captured into ``g``'s family; returns the eager outputs."""
        r = self.runner
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(r.device)
        cap = StepGraph({"ints": torch.empty(ints_h.shape, dtype=ints_h.dtype,
                                             device=r.device),
                         "temp": torch.empty(temp_h.shape, dtype=temp_h.dtype,
                                             device=r.device)}, None, {})

        def run():
            return body(cap.inputs["ints"], cap.inputs["temp"])

        with capturing(r.device) as stream:
            stream.wait_stream(current)
            with torch.cuda.stream(stream), r._bound(g.tree), \
                    torch.inference_mode():
                cap.inputs["ints"].copy_(ints_h, non_blocking=True)
                cap.inputs["temp"].copy_(temp_h, non_blocking=True)
                out = run()
            current.wait_stream(stream)
            for o in out:
                o.record_stream(current)
            torch.cuda.synchronize(r.device)
            with r._bound(g.tree), torch.inference_mode():
                cap.capture(run, stream, pool=g.family.pool)
        g.family.graphs[key] = cap
        r.compiles += 1
        r.capture_s += time.perf_counter() - t0
        return out

    # -- dispatches -------------------------------------------------------------

    def _batch_rung(self, rungs, n: int) -> int:
        for r in rungs:
            if r >= n:
                return r
        raise ValueError(f"batch of {n} exceeds top rung {rungs[-1]} — the "
                         f"scheduler chunks above this")

    def _table(self, page_lists, b: int) -> np.ndarray:
        """Per-row page lists padded into the (b, P) dispatch table: P is
        the page rung over the widest row, unused entries point at
        scratch (their positions lie past every row's fill, so the masks
        never let them matter)."""
        width = self._page_rung(max([len(p) for p in page_lists] + [1]))
        tbl = np.full((b, width), self.scratch, np.int64)
        for i, pages in enumerate(page_lists):
            tbl[i, :len(pages)] = pages
        return tbl

    @staticmethod
    def _sampling_args(b, temps, top_ks, seeds):
        """(temperatures (b,) float32, top-k (b,) int64, seeds (b,) int64
        of uint32 values), pad rows greedy."""
        tp = np.zeros((b,), np.float32)
        tp[:len(temps)] = temps
        tk = np.zeros((b,), np.int64)
        tk[:len(top_ks)] = top_ks
        sd = np.zeros((b,), np.int64)
        sd[:len(seeds)] = np.asarray(seeds, np.int64) & 0xFFFFFFFF
        return tp, tk, sd

    def prefill_async(self, x: np.ndarray, t0s, n_new, page_lists, temps,
                      top_ks, seeds, generation: Optional[Generation] = None):
        """Dispatch one prefill chunk over co-batched rows without
        fetching: row ``i`` holds prompt tokens ``x[i, :n_new[i]]`` at
        global positions from ``t0s[i]``, its cache (covering ``[0, t0 +
        n_new)``) listed in ``page_lists[i]``.  Returns ((b,) device
        tokens, (b,) device log-probabilities, (b, vocab) device logits,
        generation id).  Rows pad to a prefill rung against scratch; the
        sampled token is the row's next token only when the chunk ends
        its prompt."""
        n, c = x.shape
        if c != self.prefill_chunk:
            raise ValueError(f"chunk width {c} != prefill_chunk "
                             f"{self.prefill_chunk}")
        b = self._batch_rung(self.prefill_rungs, n)
        xb = np.zeros((b, c), np.int64)
        xb[:n] = x
        t0 = np.zeros((b,), np.int64)
        t0[:n] = t0s
        nn = np.ones((b,), np.int64)
        nn[:n] = n_new
        tbl = self._table(list(page_lists) + [[]] * (b - n), b)
        tp, tk, sd = self._sampling_args(b, temps, top_ks, seeds)
        ints = np.concatenate([tbl.reshape(-1), xb.reshape(-1), t0, nn, tk,
                               sd])
        (tok, logp, logits), gen = self._dispatch(
            ("prefill", b, tbl.shape[1]), ints, tp, generation)
        return tok, logp, logits, gen

    def prefill(self, x: np.ndarray, t0s, n_new, page_lists, temps, top_ks,
                seeds):
        """:meth:`prefill_async` fetched: host arrays of the real rows."""
        tok, logp, logits, gen = self.prefill_async(
            x, t0s, n_new, page_lists, temps, top_ks, seeds)
        n = len(page_lists)
        return (tok.cpu().numpy()[:n], logp.cpu().numpy()[:n],
                logits.cpu().numpy()[:n], gen)

    def decode_async(self, page_lists, tokens, ts, temps, top_ks, seeds,
                     generation: Optional[Generation] = None):
        """Dispatch one decode step over co-batched requests without
        fetching: row ``i`` feeds ``tokens[i]`` at its own depth ``ts[i]``
        and appends its key and value to its paged cache.  Returns as
        :meth:`prefill_async`.  The scheduler dispatches every chunk of a
        tick before it fetches any."""
        n = len(page_lists)
        b = self._batch_rung(self.decode_rungs, n)
        tbl = self._table(list(page_lists) + [[]] * (b - n), b)
        tk_in = np.zeros((b,), np.int64)
        tk_in[:n] = tokens
        tt = np.zeros((b,), np.int64)
        tt[:n] = ts
        tp, tk, sd = self._sampling_args(b, temps, top_ks, seeds)
        ints = np.concatenate([tbl.reshape(-1), tk_in, tt, tk, sd])
        (tok, logp, logits), gen = self._dispatch(
            ("decode", b, tbl.shape[1]), ints, tp, generation)
        return tok, logp, logits, gen

    def decode(self, page_lists, tokens, ts, temps, top_ks, seeds):
        """:meth:`decode_async` fetched: host arrays of the real rows."""
        tok, logp, logits, gen = self.decode_async(
            page_lists, tokens, ts, temps, top_ks, seeds)
        n = len(page_lists)
        return (tok.cpu().numpy()[:n], logp.cpu().numpy()[:n],
                logits.cpu().numpy()[:n], gen)

    def copy_page(self, src: int, dst: int,
                  generation: Optional[Generation] = None) -> None:
        """Copy page ``src`` into ``dst`` across every layer's keys and
        values (the copy-on-write move); the references are the
        caller's."""
        self._dispatch(("copy",), np.asarray([src, dst], np.int64),
                       np.zeros((1,), np.float32), generation)

    # -- the family ---------------------------------------------------------------

    def executables(self) -> int:
        """The generation family's size: the warm proof's share of the
        expected count."""
        return ((len(self.prefill_rungs) + len(self.decode_rungs))
                * len(self.page_rungs) + 1)

    def keys(self) -> List[tuple]:
        """The family's keys in warm-up order."""
        return ([("prefill", b, w) for b in self.prefill_rungs
                 for w in self.page_rungs]
                + [("decode", b, w) for b in self.decode_rungs
                   for w in self.page_rungs] + [("copy",)])

    def warm_one(self, key: tuple, generation: Optional[Generation] = None):
        """One dispatch of ``key`` with every row against the scratch page
        (no real page is touched) at position 0, greedy; returns the host
        (tokens, logprobs, logits), or None for the copy."""
        if key[0] == "copy":
            self.copy_page(self.scratch, self.scratch, generation)
            return None
        kind, b, width = key
        z = np.zeros(b, np.int64)
        zf = np.zeros(b, np.float32)
        pages = [[self.scratch] * width] * b
        if kind == "prefill":
            out = self.prefill_async(
                np.zeros((b, self.prefill_chunk), np.int64), z,
                np.ones(b, np.int64), pages, zf, z, z, generation)
        else:
            out = self.decode_async(pages, z, z, zf, z, z, generation)
        return tuple(o.cpu().numpy() for o in out[:3])

    def warmup(self, generation: Optional[Generation] = None) -> int:
        """Enter the whole family up front (the captures on the card);
        ``generation`` is a swap's pending tree.  Returns the runner's
        ``compiles`` afterwards."""
        for key in self.keys():
            self.warm_one(key, generation)
        return self.runner.compiles

    def graph_cache_size(self) -> int:
        """The generation keys of the live family: after warmup it equals
        :meth:`executables`."""
        return sum(1 for k in self.runner._active.family.graphs
                   if k[0] in ("prefill", "decode", "copy"))

    def stats(self) -> Dict:
        counts = self.prefix_counts()
        return {"page_size": self.page_size,
                "num_pages": self.num_pages,
                "page_rungs": list(self.page_rungs),
                "prefill_chunk": self.prefill_chunk,
                "max_ctx": self.max_ctx,
                "slots": self.slots,
                "prefill_rungs": list(self.prefill_rungs),
                "decode_rungs": list(self.decode_rungs),
                "pages_active": self.pages_active(),
                "pages_free": len(self._free_pages),
                "pages_shared": int((self.page_ref > 1).sum()),
                "pages_leaked": self.pages_leaked(),
                "prefix_enabled": self.prefix is not None,
                "prefix_pages": (len(self.prefix)
                                 if self.prefix is not None else 0),
                "prefix_hits": counts["hits"],
                "prefix_misses": counts["misses"],
                "prefix_evictions": counts["evictions"],
                "prefix_tokens_avoided": counts["tokens_avoided"],
                "occupancy": self.occupancy(),
                "executables": self.executables(),
                "graph_cache_size": self.graph_cache_size()}
