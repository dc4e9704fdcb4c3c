"""ModelRunner: a built workflow frozen into an inference forward (port
of the single-device core of ``znicz_tpu/serving/model.py``).

The forward IS ``FusedTrainer.forward_pass(train=False)``, the same
routing the reference serves.  Parameters stay on the workflow's device
and are never written; every dispatch runs under
``torch.inference_mode()``.  The output is the last module's: LOGITS for
a softmax head.

**Staging**: :meth:`stage` copies a host batch to the device from pinned
memory on a side stream and records an event; :meth:`infer_staged`
makes the compute stream wait on that event.  So staging batch N+1
overlaps the compute of batch N, the reference's ping-pong discipline
(the frontend's compute loop drives it).  :meth:`host_buffer` hands out
the pinned buffer a batch is assembled in, so the assembly is the only
host copy.

The ``generation`` stamp of every reply is kept (1 until snapshot
rollover exists).  The mesh, AOT executables, snapshot swap, chaos hooks
and generation serving come in later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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

    def __init__(self, workflow):
        self.workflow = workflow
        self.device: torch.device = workflow.device
        self._trainer = FusedTrainer(workflow)
        #: per-sample input shape the service accepts
        self.sample_shape: Tuple[int, ...] = tuple(workflow.sample_shape)
        #: staging dtype (uint8 stays 1 byte on the wire; decoded on device)
        self.dtype = np.dtype(workflow.dtype)
        self._torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        #: snapshot generation stamped on every reply
        self.generation = 1
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

    def infer_staged(self, staged: Staged):
        """Dispatch the forward on a staged batch; returns ``(device
        result, generation)``.  The result is not synchronised: reading it
        on the host is the sync point."""
        x = staged.x
        if staged.event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.event)
            x.record_stream(compute)
        with torch.inference_mode():
            y = self._trainer.forward_pass(self._trainer._decode(x))
        self.dispatches += 1
        return y, self.generation

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
