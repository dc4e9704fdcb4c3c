"""ModelRunner: a built workflow frozen into an inference forward (port
of the single-device core of ``znicz_tpu/serving/model.py``, with its
snapshot load, swap and rollback).

The forward IS ``FusedTrainer.forward_pass(train=False)``, the same
routing the reference serves.  Parameters stay on the workflow's device
and are never written by a dispatch; every dispatch runs under
``torch.inference_mode()``.  The output is the last module's: LOGITS for
a softmax head.

**Staging**: :meth:`stage` copies a host batch to the device from pinned
memory on a side stream and records an event; :meth:`infer_staged`
makes the compute stream wait on that event.  So staging batch N+1
overlaps the compute of batch N, the reference's ping-pong discipline
(the frontend's compute loop drives it).  :meth:`host_buffer` hands out
the pinned buffer a batch is assembled in, so the assembly is the only
host copy.

**Generations.**  ``ModelRunner(workflow, snapshot=path)`` loads the
snapshot's forward parameters into the modules before it freezes them
(``snapshotter.load_inference``).  The served parameters are a
``(params tree, generation)`` tuple, read once a dispatch; the reference
serves a function of that tree, the port's forward reads the modules'
own parameters, so each dispatch binds the tree it read to the modules
for the length of its forward, under the runner's dispatch lock, and
stamps its reply with that tuple's generation.  :meth:`swap` loads a
snapshot into a new tree (never into the live modules), warms it through
every ladder rung (each warm dispatch takes the lock, so served batches
interleave with the warm and each sees exactly one generation), then
flips the tuple; the generation id comes from a high-water mark, and the
displaced tuple is kept for one disk-free :meth:`rollback`.  A
concurrent swap, a snapshot that does not cover the model, or a failed
warm raises, is counted in ``swap_failures``, and leaves the live
generation serving.

CUDA-graph capture per ladder rung, the serving mesh, the chaos hooks
and the AOT executable cache wait for the rest of ROADMAP A.6,
generation serving for A.8.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from znicz_torch.parallel.fused import FusedTrainer


class Staged(NamedTuple):
    """A batch on its way to the device: the device tensor, the event its
    copy completes on (None on the CPU), and the host buffer it came
    from, kept alive until the copy is done."""

    x: torch.Tensor
    event: Optional[object]
    host: Optional[torch.Tensor]


class ModelRunner:
    """Freeze a built workflow (``StandardWorkflow``) into its inference
    forward on the workflow's device."""

    def __init__(self, workflow, snapshot: str = ""):
        if snapshot:
            from znicz_torch import snapshotter

            snapshotter.load_inference(workflow, snapshot)
        self.workflow = workflow
        self.device: torch.device = workflow.device
        self._trainer = FusedTrainer(workflow)
        #: (params tree, generation): read once a dispatch, flipped as one
        #: tuple by swap() and rollback()
        self._active = ({f.name: {k: p.detach() for k, p in
                                  FusedTrainer._params_of(f).items()}
                         for f in self._trainer._weighted()}, 1)
        #: the snapshot the live generation came from ("" at random init)
        self.snapshot_path: str = snapshot or ""
        #: the tuple the last swap displaced, and its path: one rollback
        self._previous: Optional[Tuple] = None
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
        #: per-sample input shape the service accepts
        self.sample_shape: Tuple[int, ...] = tuple(workflow.sample_shape)
        #: staging dtype (uint8 stays 1 byte on the wire; decoded on device)
        self.dtype = np.dtype(workflow.dtype)
        self._torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        #: forward dispatches since construction (or the last reset)
        self.dispatches = 0
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)

    # -- the two halves of the ping-pong ---------------------------------------

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
        buffer."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, self.dtype))
        if x.dtype != self._torch_dtype:
            raise TypeError(f"staged batch is {x.dtype}, the service "
                            f"stages {self._torch_dtype}")
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
        return self._active[1]

    def infer_staged(self, staged: Staged, params: Optional[Dict] = None):
        """Dispatch the forward on a staged batch; returns ``(device
        result, generation)``.  The result is not synchronised: reading it
        on the host is the sync point.  ``params`` (a swap's warm) serves
        that tree instead of the live generation, stamped 0."""
        x = staged.x
        if staged.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.event)
            x.record_stream(compute)
        with self._dispatch_lock:
            tree, gen = self._active if params is None else (params, 0)
            with self._bound(tree), torch.inference_mode():
                y = self._trainer.forward_pass(self._trainer._decode(x))
            self.dispatches += 1
        return y, gen

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

    # -- snapshot rollover -----------------------------------------------------

    def swap(self, path: str, ladder=None) -> Dict:
        """Load the snapshot at ``path`` into a new parameter tree, warm it
        through every rung of ``ladder`` (each warm dispatch interleaves
        with served ones under the dispatch lock), then flip ``(params,
        generation)`` at once; served batches keep the old generation
        until the flip.  A concurrent swap, a snapshot that does not
        cover the model, or a failed warm raises and leaves the live
        generation serving (``swap_failures`` counts it).  Returns the
        snapshot's metadata."""
        from znicz_torch import snapshotter

        if not self._swap_lock.acquire(blocking=False):
            self.swap_failures += 1
            raise RuntimeError("swap already in progress")
        try:
            self.swapping = True
            try:
                snap = snapshotter.Snapshotter.load(path)
                params = snapshotter.inference_params(self.workflow, snap)
                for bucket in (ladder.buckets() if ladder is not None
                               else ()):
                    x = np.zeros(self.bucket_shape(bucket), self.dtype)
                    y, _ = self.infer_staged(self.stage(x), params)
                    y.cpu()
                with self._dispatch_lock:
                    old_params, old_gen = self._active
                    self._previous = (old_params, old_gen,
                                      self.snapshot_path)
                    self._gen_hwm += 1
                    self._active = (params, self._gen_hwm)
                    self.snapshot_path = path
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
        """Serve again the tuple the last :meth:`swap` displaced, its
        generation stamp included, with no disk read; once.  Raises
        ``RuntimeError`` when nothing is kept or a swap is under way (the
        live generation serving on).  Returns the generation."""
        if not self._swap_lock.acquire(blocking=False):
            raise RuntimeError("swap in progress: rollback refused")
        try:
            if self._previous is None:
                raise RuntimeError("no previous generation kept (nothing "
                                   "was swapped, or it was rolled back)")
            params, gen, path = self._previous
            with self._dispatch_lock:
                self._previous = None
                self._active = (params, gen)
                self.snapshot_path = path
            self.rollbacks += 1
            return gen
        finally:
            self._swap_lock.release()

    def stats(self) -> Dict:
        return {"generation": self.generation, "swapping": self.swapping,
                "snapshot_path": self.snapshot_path,
                "swaps": self.swaps, "swap_failures": self.swap_failures,
                "rollbacks": self.rollbacks, "dispatches": self.dispatches}

    # -- conveniences ----------------------------------------------------------

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
        """Run every ladder rung once (cuDNN algorithm choice, kernel
        builds, allocator growth happen here, not under traffic); returns
        the dispatch count afterwards."""
        for bucket in ladder.buckets():
            self.infer(np.zeros(self.bucket_shape(bucket), self.dtype))
        return self.dispatches
