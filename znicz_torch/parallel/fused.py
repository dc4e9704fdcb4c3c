"""The fused trainer (port of ``FusedTrainer`` in
``znicz_tpu/parallel/fused.py``: the forward pass, the loss head, the
train and eval steps, and a sequential epoch loop).

The forward composes the modules' own forwards, except where the
planners route a span through a fused stage: with
``root.common.engine.fused_elementwise`` each conv1/conv2-style block
(ConvStrictRELU, or a plain Conv and a StrictRELU activation layer ->
LRN -> exactly tiling MaxPooling) runs as the raw convolution plus the
block kernels (K1 forward, K1b backward); with ``fused_tail`` each
remaining ConvStrictRELU (or Conv + StrictRELU layer) runs as the raw
convolution
plus the bias+ReLU kernels (K2, K2b), each All2AllStrictRELU(+dropout)
as the raw product plus the FC epilogue, each SeqAll2AllStrictRELU as
the per-token product plus the same epilogue, and the loss as the fused
softmax-CE head.  ``pallas_lrn`` sends the LRN modules through K3/K3b.
A softmax head emits LOGITS, a sequence head (``SeqAll2AllSoftmax``)
(batch, seq, vocab) logits, which the loss head flattens into
``batch * seq`` token rows.  The plans are read from the knobs on every
call.  Under any evaluator but ``EvaluatorSoftmax`` the loss is the
reference's MSE head: half the sum of squares of the last module's
output less the loader's targets (``FullBatchLoaderMSE.gather_targets``)
over the valid rows, over their count, in float32 and never through the
fused softmax head; the Decision gets n_err and a confusion only if it
has them (``DecisionMSE`` has not).

A train step is one autograd pass over the loss, then ``sgd_update`` per
parameter with the bias/weight hyperparameter split, as the reference's
``_update_core``; the parameters and velocities are updated in place.
The hyperparameters of a step are its row of a (k, M, 8) float32 tensor
on the device, one row of 8 for each of the M weighted modules
(:meth:`FusedTrainer.tiled_hypers`, :meth:`FusedTrainer._hypers_rows`),
with a workflow's ``lr_adjust`` advanced between rows as the reference
advances it.  Under ``remat`` (``root.common.engine.remat``) each block
of the forward chain (a module with weights and the modules without
weights after it: a convolution with its activation, LRN and pool, an
FC layer with its dropout) runs under its own non-reentrant
``torch.utils.checkpoint`` and is recomputed in the backward one block
at a time, so only the blocks' inputs stay live between the passes;
the loss head stays outside, and the loss and the update are the same
bits.  The masks and offsets are keyed by (step, index), so a recompute
draws the ones the forward drew.

**The segmented run** (:meth:`FusedTrainer.run`, the reference's
``_run_segmented``).  Consecutive non-tail TRAIN minibatches form a
segment of up to ``scan_chunk`` steps (``root.common.engine.scan_chunk``,
default 8), consecutive TEST or VALID minibatches of one class an eval
segment, and the epoch tail goes alone.  A segment's index rows reach the
device as one (k, B) tensor, and its losses and error counts stay there
as (k,) tensors until the next segment is queued (the one-deep flush);
the confusion is summed on the device over the epoch and handed to the
Decision at the tail.  The tail keeps its order: an eval step replays the
train forward with the step's masks, the Decision rules on its metrics,
and the update applies only if ``gd_skip`` stayed open.  At each epoch's
end the workflow's ``snapshotter`` runs: on a background thread under
``async_snapshot`` (device clones of the state handed to
``Snapshotter.save_async``), else in line.  ``scan_chunk`` 1 is the
step-at-a-time loop.

**The deep pipeline** (``root.common.engine.pipeline_depth`` above 1, the
reference's ``_run_deep``).  Whole epochs are queued back to back, each
in the segmented run's segments and order, and the host reads nothing of
an epoch when it queues it: its losses and error counts stay on the
device, packed into one vector, its confusions stacked.  Once ``2 *
pipeline_depth`` epochs are in flight the ``pipeline_depth`` oldest are
flushed: their vectors are joined on the device, read in one transfer
and fed to the Decision in loader order.  Each epoch's tail update is
applied unless the tail reaches ``max_epochs``; a stop that a flush finds
(``fail_iterations``) copies back the clone of the parameters and
velocities taken before that tail's update, drops the epochs queued
after it and rewinds ``steps_done``, the ``lr_adjust`` iteration, the
prng streams and the loader to that tail, so the run stops in the
segmented run's state, bit for bit.  A flushed epoch's snapshot holds
its own post-epoch state (the next epoch's input clone) and the loader
and streams of its tail.  Host-staged loaders, plotters, and an active
snapshotter without ``async_snapshot`` keep the segmented run.  Host
arrays reach the card through pinned memory without a wait
(:meth:`FusedTrainer._put`).

**CUDA graphs.**  On the card, with ``scan_chunk`` above 1, each step of
a segment is a replay of a captured step (``parallel/graphs.py``), one
capture for each (kind, batch size, routing, dtype, inputs): the first
step of a key runs eagerly on the capture stream, which builds the
kernels, picks cuDNN's plans and sizes the workspaces, then the step is
captured.  Before each replay the step's index row (or staged rows), its
hyperparameter row and its dropout masks, drawn with the generator the
eager step draws them with, are copied into the capture's buffers.  A
net with stochastic pooling samples its offsets from probabilities
computed inside the step, so it runs every segment uncaptured, by rule,
as does a net whose attention rings over host-staged sends and receives
(``uncaptured_reason``); ``stats`` counts ``captured_steps`` and
``eager_steps``.  A failed capture raises.

**Streaming** (``loader/streaming.py``).  A ``StreamingLoader`` whose
dataset is not resident is staged: each segment's rows are gathered on
the host into pinned memory in their storage dtype, copied to the device
on a copy stream and ordered by an event, and decoded in the step.  With
``async_staging`` a ``DeviceStager`` assembles the predicted next
segments while the current one runs; ``prefetch_segments`` segments of
rows are submitted to an image source's ``DecodePool`` ahead.  Under
``staging_donate`` a consumed segment's device buffers go back to the
trainer's free list (released by an event after its last read) for a
later segment of the same shape; off, they are freed by reference count.

**Mixed precision** (the reference's ``compute_dtype``, ``master_dtype``
and ``state_dtype`` knobs).  Under ``compute_dtype`` bf16 each step reads
every float32 parameter as its bf16 cast (the reference's ``cparams``;
gradients reach the stored parameters through the cast), casts the input
and then the activation entering every module to bf16, and casts the
logits to float32 before the loss.  Convolutions and products of bf16
operands give bf16; a bf16 activation times a float32 dropout mask is
float32 until the next module's cast.  Under ``master_dtype`` "bfloat16"
the parameters are stored bf16 from the first train step on and updated
in float32; under ``state_dtype`` "bfloat16" the velocities are
(``nn_units.sgd_update``).  ``forward_pass`` itself casts nothing:
serving stays float32.  No ``torch.autocast``: its per-op lists keep some
ops in float32 where the reference does not.

**On a mesh** (``FusedTrainer(wf, mesh=make_mesh(...))``, one process a
rank; ``parallel/mesh.py``).  Rank (d, m) takes rows ``[d·n, (d+1)·n)`` of
each minibatch's index row, ``n = ceil(B / dp)`` (rows past B are
padding), gathers or stages only those, and counts a row valid when its
global position is below the minibatch's size; the loss divides by that
global size.  The gradients are summed over the ``data`` group in one
collective before the update, so every rank applies the same update to
its own shards.  Wide FC layers (:meth:`FusedTrainer.place_state`)
hold only their rows of the ``model`` coordinate: the input enters
through ``copy_to_model``, the local rows go through the activation or
the FC epilogue, and the columns are gathered.  Dropout masks and
stochastic pooling's offsets are drawn at the global shape and each
rank takes its rows (and columns), so a meshed run draws one process's.
With ``root.common.engine.seq_parallel`` above 1, every
``MultiHeadAttention`` is bound to the mesh (``bind_sequence_mesh``):
its core rings over the ``model`` group, each rank of it attending its
block of the sequence.  A mesh whose ``model`` axis is 1 is refused
with ``ValueError``: its ranks hold different rows, and a ring over
them would join blocks of different samples.
The metrics are summed over ``data`` on the device before any host read
(the deep pipeline's epoch vector once).  A meshed run is not captured
(``uncaptured_reason``): neither gloo's collectives nor the ring's
host-staged sends and receives can live in a CUDA graph.  A 1 × 1 mesh
is None: the single-device path.

**Dropout masks.**  ``mask_fn(step, index, shape, ratio)`` supplies the
mask of forwards index ``index`` at train step ``step``; by default it
draws :meth:`DropoutForward.make_mask` from the ``fused_trainer`` stream's
generator for (step, index) on the workflow's device, so the same
(step, index) always gives the same mask — the FC epilogue's backward
regenerates it instead of keeping it.  Tests pass the reference's masks
through this seam.

**Stochastic pooling.**  In a train step (and the epoch tail's replay) a
stochastic pooling module outputs the element at offsets sampled from
its window probabilities, ``offset_fn(step, index, probs)``, whose
gradient is scattered back to those positions
(``pooling._StochasticSelect``); by default the offsets are drawn with
:meth:`StochasticPoolingBase.sample_offsets` from the same generator as
a mask of that (step, index).  In evaluation, and in serving, the module
outputs its expectation.  Tests pass the reference's offsets through
this seam.

**Telemetry** (the ``trainer`` scope).  ``train_steps`` counts the TRAIN
minibatches run (the tail's included, as the reference counts it),
``images`` their images, and ``step_seconds`` (while telemetry is
enabled) each accounted interval over its steps.  Spans: ``dispatch``
around each train segment's dispatch, ``flush`` around its read-back,
``tail`` and ``eval``.  Under ``--profile-dir`` each train segment's
dispatch is one ``torch.profiler`` range ``train_step#<first step>``
(``telemetry.step_annotation``).  All of it happens on the host around
the dispatches: a replay runs no Python, so nothing is observed inside
a captured step.
"""

from __future__ import annotations

import contextlib
import copy
import sys
import threading
import time
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from znicz_torch import telemetry
from znicz_torch.all2all import All2All, All2AllSoftmax
from znicz_torch.attention import (MultiHeadAttention, SeqAll2AllSoftmax,
                                   seq_parallel_size)
from znicz_torch.core import prng
from znicz_torch.core.config import ENGINE_DEFAULTS, check_engine_knobs, root
from znicz_torch.core.mutable import Bool
from znicz_torch.dropout import DropoutForward
from znicz_torch.evaluator import EvaluatorSoftmax, confusion
from znicz_torch.fused_block import (fused_bias_relu, fused_block,
                                     fused_fc_epilogue, fused_softmax_xent,
                                     plan_fused_blocks, plan_fused_tail)
from znicz_torch.loader.base import TRAIN
from znicz_torch.nn_units import params_of, sgd_update, state_dtype
from znicz_torch.ops.linear import linear, seq_linear
from znicz_torch.parallel import mesh as mesh_mod
from znicz_torch.parallel.graphs import StepGraph, capturing
from znicz_torch.pooling import StochasticPoolingBase

MaskFn = Callable[[int, int, tuple, float], torch.Tensor]
OffsetFn = Callable[[int, int, torch.Tensor], torch.Tensor]


def compute_dtype() -> torch.dtype:
    """``root.common.engine.compute_dtype`` ("float32", "bf16" or
    "bfloat16"), or the legacy ``precision`` when it is unset, as a torch
    dtype.  Any other value raises."""
    eng = root.common.engine
    cd = eng.get("compute_dtype", None)
    if cd is None:
        cd = eng.get("precision", "float32")
    cd = {"bf16": "bfloat16"}.get(str(cd), str(cd))
    if cd not in ("float32", "bfloat16"):
        raise ValueError(f"root.common.engine.compute_dtype={cd!r}: must be "
                         "'float32' or 'bf16'/'bfloat16'")
    return torch.float32 if cd == "float32" else torch.bfloat16


def master_dtype() -> Optional[torch.dtype]:
    """``torch.bfloat16`` under ``root.common.engine.master_dtype``
    "bfloat16" (parameters stored bf16), None under "float32".  Any other
    value raises."""
    md = str(root.common.engine.get("master_dtype", "float32"))
    if md not in ("float32", "bfloat16"):
        raise ValueError(f"root.common.engine.master_dtype={md!r}: must be "
                         "'float32' or 'bfloat16'")
    return None if md == "float32" else torch.bfloat16


class FusedUnsupportedError(ValueError):
    """The workflow's graph cannot run on the fused trainer (tied
    weights).  ``engine.train`` catches exactly this to train on the unit
    engine instead; any other error propagates."""


class StagedSegment:
    """A staged segment on the trainer's device: ``data`` (k, B, ...) in
    the storage dtype, ``target`` (k, B) labels or (k, B, ...) targets,
    and ``ready``, the event of their copy (None on the CPU)."""

    def __init__(self, data, target, ready=None):
        self.data, self.target, self.ready = data, target, ready

    def consume(self) -> Dict[str, torch.Tensor]:
        """The segment's inputs, ordered after their copy on the current
        stream, which the allocator is told reads them."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.data.device)
            stream.wait_event(self.ready)
            self.data.record_stream(stream)
            self.target.record_stream(stream)
        return {"data": self.data, "target": self.target}


class _Buffers:
    """The free list of consumed staged buffers (``staging_donate``): a
    buffer goes back with the event recorded after its last read (none
    on the CPU), and the copy stream waits on that event before it writes
    the buffer again."""

    def __init__(self):
        self._free: Dict[tuple, List[Tuple[torch.Tensor, object]]] = {}
        self._lock = threading.Lock()
        #: buffers written again instead of allocated
        self.reused = 0

    def give_back(self, *tensors) -> None:
        event = None
        if tensors[0].is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(tensors[0].device))
        with self._lock:
            for t in tensors:
                key = (tuple(t.shape), t.dtype)
                self._free.setdefault(key, []).append((t, event))

    def take(self, shape, dtype, device, stream=None) -> torch.Tensor:
        with self._lock:
            free = self._free.get((tuple(shape), dtype))
            if free:
                t, event = free.pop()
                self.reused += 1
                if event is not None:
                    stream.wait_event(event)
                return t
        return torch.empty(shape, dtype=dtype, device=device)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


class _PinnedBuffers:
    """Pinned host memory for staged segments: byte buffers, each handed
    out as a view of the shape and dtype asked for and given back with the
    event of the copy that reads it, then written again, for any shape
    that fits, once that event has completed.  A run pays for pinning only
    while every buffer is in flight."""

    def __init__(self):
        self._free: List[Tuple[torch.Tensor, object]] = []
        self._lock = threading.Lock()

    def take(self, shape, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the byte buffer, its view of ``shape`` and ``dtype``)."""
        nbytes = int(np.prod(shape)) * torch.empty(
            (), dtype=dtype).element_size()
        buf = None
        with self._lock:
            for i, (b, event) in enumerate(self._free):
                if b.numel() >= nbytes and event.query():
                    buf = self._free.pop(i)[0]
                    break
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf, buf[:nbytes].view(dtype).view(shape)

    def give_back(self, event, *bufs) -> None:
        with self._lock:
            self._free.extend((b, event) for b in bufs)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


class FusedTrainer:
    """Train and run a built ``StandardWorkflow`` (its ``forwards``,
    ``gds``, ``loader``, ``evaluator`` and ``decision``) on its device.  A
    workflow built without a loader can only run :meth:`forward_pass`
    (serving)."""

    #: steps a segment, unless ``root.common.engine.scan_chunk`` names a
    #: count; 1 runs step at a time, uncaptured
    scan_chunk = 8
    #: epochs queued before their metrics are read, unless
    #: ``root.common.engine.pipeline_depth`` names a depth; above 1 (and
    #: :meth:`_deep_eligible`) :meth:`run` takes the deep pipeline
    pipeline_depth = 1

    #: FC layers at least this wide are column-sharded over the mesh's
    #: ``model`` axis (AlexNet's 4096-wide fc6/fc7)
    tp_threshold = 1024

    def __init__(self, workflow, mask_fn: Optional[MaskFn] = None,
                 offset_fn: Optional[OffsetFn] = None, remat=None,
                 mesh=None):
        if remat is None:
            remat = bool(root.common.engine.get("remat", False))
        self.remat = bool(remat)
        self.scan_chunk = int(root.common.engine.get(
            "scan_chunk", type(self).scan_chunk))
        if self.scan_chunk < 1:
            raise ValueError(f"root.common.engine.scan_chunk="
                             f"{self.scan_chunk}: must be at least 1")
        self.pipeline_depth = int(root.common.engine.get(
            "pipeline_depth", type(self).pipeline_depth))
        if self.pipeline_depth < 1:
            raise ValueError(f"root.common.engine.pipeline_depth="
                             f"{self.pipeline_depth}: must be at least 1")
        self.workflow = workflow
        self.forwards = list(workflow.forwards)
        self.device = workflow.device
        self.loader = getattr(workflow, "loader", None)
        self.decision = getattr(workflow, "decision", None)
        self.gd_of = dict(getattr(workflow, "gds", {}))
        # one tensor in two modules would need a joint update the fused
        # step does not make: refused, as the reference refuses it
        seen = {}
        for f in self.forwards:
            for k, p in params_of(f).items():
                if id(p) in seen:
                    raise FusedUnsupportedError(
                        f"fused trainer does not support tied weights "
                        f"({f.name}.{k} shares {seen[id(p)]})")
                seen[id(p)] = f"{f.name}.{k}"
        ev = getattr(workflow, "evaluator", None)
        #: the loss head: softmax-CE for a softmax evaluator, else the
        #: half sum of squares against the loader's targets
        self.loss_kind = ("mse" if ev is not None
                          and not isinstance(ev, EvaluatorSoftmax)
                          else "softmax")
        self.compute_confusion = (bool(ev.compute_confusion)
                                  if getattr(ev, "confusion_explicit", False)
                                  else True)
        # uint8 rows decode as u8 * scale + shift: the loader's constants
        # (a StreamingLoader), else the workflow's (served requests)
        dec = self.loader if hasattr(self.loader, "scale") else workflow
        self._decode_params = (float(getattr(dec, "scale", 1.0)),
                               float(getattr(dec, "shift", 0.0)))
        self.mask_fn: MaskFn = mask_fn or self.default_mask
        self.offset_fn: OffsetFn = offset_fn or self.default_offsets
        self.lr_adjust = getattr(workflow, "lr_adjust", None)
        self.steps_done = 0
        #: ``img_per_sec`` counts every step; ``warm_*`` leave out the
        #: first interval of each kind (train segments by length, tail,
        #: eval), which pays the kernel builds, cuDNN's plan choice and
        #: the captures.  ``captured_steps`` are graph replays,
        #: ``eager_steps`` every other step (warm-ups, tails, and every
        #: step of an uncaptured run).  Host seconds: ``warmup_s`` of the
        #: steps run before a capture (to their end on the card),
        #: ``capture_s`` of the captures; ``stage_gather_s`` of the host
        #: gathers into pinned memory and ``stage_copy_s`` of enqueuing
        #: the copies, summed over the threads that stage.  The deep
        #: pipeline's: ``deep_epochs`` queued, ``deep_flushes`` epochs
        #: fed to the Decision, ``deep_pulls`` reads of their metrics
        #: (one for several epochs), ``deep_rollbacks``, the most epochs
        #: in flight, and the train and eval steps queued and then
        #: rolled back (``train_steps`` and ``eval_steps`` count the
        #: steps kept, as a segmented run does).  On a mesh: the
        #: ``collectives`` of a run, their ``collective_bytes`` and their
        #: host seconds ``collective_s`` (``parallel/mesh.STATS``)
        self.stats = {"train_steps": 0, "eval_steps": 0, "images": 0,
                      "wall_s": 0.0, "img_per_sec": 0.0, "warm_images": 0,
                      "warm_wall_s": 0.0, "warm_img_per_sec": 0.0,
                      "captured_steps": 0, "eager_steps": 0,
                      "warmup_s": 0.0, "capture_s": 0.0,
                      "staged_segments": 0, "stage_gather_s": 0.0,
                      "stage_copy_s": 0.0, "deep_epochs": 0,
                      "deep_flushes": 0, "deep_pulls": 0,
                      "deep_rollbacks": 0, "deep_inflight_max": 0,
                      "deep_discarded_train_steps": 0,
                      "deep_discarded_eval_steps": 0, "collectives": 0,
                      "collective_bytes": 0, "collective_s": 0.0}
        # the reference's name for them on the workflow (web_status and
        # publishing read it)
        workflow.fused_stats = self.stats
        self._stats_lock = threading.Lock()
        # hot-loop metrics and spans: the progress counters always count
        # (a dashboard must never read a live run as stalled); the step
        # histogram and the spans only while telemetry is enabled
        self._tracer = telemetry.tracer()
        _sc = telemetry.scope("trainer")
        self._m_train_steps = _sc.counter("train_steps",
                                          "fused train steps dispatched")
        self._m_images = _sc.counter("images", "training images consumed")
        self._m_step_seconds = _sc.histogram(
            "step_seconds", "per-step wall time (pipelined intervals)",
            size=4096)
        #: (kind, length) -> segments dispatched
        self.segments: Counter = Counter()
        self._captures: Dict[tuple, StepGraph] = {}
        #: why this net's segments run uncaptured on the card, or None
        self.uncaptured_reason = (
            "stochastic pooling samples its offsets inside the step"
            if any(isinstance(f, StochasticPoolingBase)
                   for f in self.forwards) else None)
        #: the mesh of ranks (None: one device), this rank's data
        #: coordinate, the groups of its data and model lines (None for an
        #: axis of one rank)
        self.mesh = mesh
        self._dp = mesh_mod.axis_size(mesh, "data")
        self._d = mesh_mod.axis_index(mesh, "data")
        self._data_group = mesh_mod.axis_group(mesh, "data")
        #: the global rows of the index rows last split over ``data``
        self._global_batch: Optional[int] = None
        if mesh is not None:
            self.uncaptured_reason = (
                "a meshed run's collectives are not captured (gloo's "
                "cannot be; NCCL's across cards are untested)")
        # seq_parallel on a mesh: every attention layer rings over the
        # trainer's ``model`` axis, as the reference binds it.  A mesh
        # with no such axis is refused: the layer's own ring would take
        # data ranks, which hold other rows.  Unmeshed, the layer's own
        # ring (every rank the whole input) is host-staged P2P, which no
        # CUDA graph can hold
        mhas = [f for f in self.forwards if isinstance(f, MultiHeadAttention)]
        sp = seq_parallel_size()
        if mesh is not None and mhas and sp > 1:
            if mesh_mod.axis_size(mesh, "model") < 2:
                shape = {a: mesh_mod.axis_size(mesh, a)
                         for a in mesh.mesh_dim_names}
                raise ValueError(
                    f"root.common.engine.seq_parallel={sp} rings attention "
                    f"over the mesh's 'model' axis, and the mesh {shape} "
                    f"has no model axis of 2 or more ranks; its data ranks "
                    f"hold different rows, so no ring can join their "
                    f"blocks: use a mesh with model >= 2 or seq_parallel 0")
            for f in mhas:
                f.bind_sequence_mesh(mesh)
        elif mesh is None and any(f._sp_size > 1 or f.sp_axis is not None
                                  for f in mhas):
            self.uncaptured_reason = (
                "ring attention's sends and receives are staged through "
                "the host and cannot be captured")
        #: the DeviceStager of a staged run while it runs, and its
        #: counters when the run ended
        self._stager = None
        self.stager_stats: Optional[dict] = None
        #: the free list of consumed staged buffers (``staging_donate``)
        self.staging_buffers = _Buffers()
        self._pinned = _PinnedBuffers()
        self._copy_stream = None
        self._reset_accounting()
        self.compute_dtype = compute_dtype()
        self.master_dtype = master_dtype()
        state_dtype()                       # a bad spelling raises here
        check_engine_knobs()
        if mesh is not None:
            self.place_state()

    @property
    def train_losses(self):
        """Losses of every TRAIN minibatch fed to the Decision, in order."""
        return self.decision.train_losses

    @property
    def staging(self) -> bool:
        """Whether each segment's rows are staged from the host: a
        streaming loader whose dataset is not resident."""
        ldr = self.loader
        return (bool(getattr(ldr, "streaming", False))
                and not ldr.device_resident)

    # -- state -----------------------------------------------------------------

    def _weighted(self):
        return [f for f in self.forwards if f.has_weights]

    @staticmethod
    def _params_of(f) -> Dict[str, torch.Tensor]:
        return params_of(f)

    # -- the mesh -------------------------------------------------------------

    @property
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """``{"data": dp, "model": mp}``, None on one device."""
        return mesh_mod.mesh_shape_dict(self.mesh)

    def place_state(self) -> None:
        """Each column-sharded parameter and its velocity replaced by this
        rank's rows (``parallel/mesh.tree_shardings`` and ``place_tree``),
        and the module marked with its ``mesh_placement``; the rest stays
        whole.  The rule is offered the FC modules stored (out, in) alone:
        the forward splits those by columns, and no other layer.  Once a
        module."""
        fcs = {f.name: f for f in self._weighted()
               if isinstance(f, All2All) and not f.weights_transposed
               and mesh_mod.placement_of(f) is None}
        params = {name: {k: p.detach()
                         for k, p in self._params_of(f).items()}
                  for name, f in fcs.items()}
        specs = mesh_mod.tree_shardings(self.mesh, params, self.tp_threshold)
        local = mesh_mod.place_tree(self.mesh, params, specs)
        for name, f in fcs.items():
            split = {k: spec for k, spec in specs[name].items() if spec}
            if not split:
                continue
            for k in split:
                setattr(f, k, nn.Parameter(
                    local[name][k],
                    requires_grad=self._params_of(f)[k].requires_grad))
            gd = self.gd_of.get(name)
            if gd is not None:
                gd.velocities.update(mesh_mod.place_tree(
                    self.mesh, {name: gd.velocities}, specs)[name])
            f.mesh_placement = mesh_mod.Placement(self.mesh, split)

    def restore_sharded(self, path: str) -> Dict:
        """Resume from the orbax directory ``path``, saved under any mesh
        shape or on one process: every parameter and velocity read
        straight into this trainer's placement (a leaf split over
        ``model`` reads only this rank's rows; without a mesh, whole
        tensors on :attr:`device`) and cast to its live dtype, so a
        float32 snapshot restores under bf16 state and the reverse.  The
        loader, decision and prng metadata are applied as
        ``snapshotter.restore`` applies them.  A collective on a mesh.
        Returns the metadata."""
        from znicz_torch import snapshotter as snap_mod

        self._init_velocities()

        def target(f, k, live):
            place = mesh_mod.placement_of(f)
            t = torch.empty_like(live.detach())
            return t if place is None else place.dtensor(k, t)

        units = {f.name: {k: target(f, k, p)
                          for k, p in self._params_of(f).items()}
                 for f in self._weighted()}
        vels = {self.gd_of[f.name].name: {
            k: target(f, k, v)
            for k, v in self.gd_of[f.name].velocities.items()}
            for f in self._weighted() if f.name in self.gd_of}
        arrays = snap_mod.load_orbax_arrays(
            path, {"units": units, "velocities": vels})
        with torch.no_grad():
            for f in self._weighted():
                for k, p in self._params_of(f).items():
                    p.copy_(snap_mod.local_tensor(
                        arrays["units"][f.name][k]))
                gd = self.gd_of.get(f.name)
                if gd is not None:
                    for k, v in gd.velocities.items():
                        v.copy_(snap_mod.local_tensor(
                            arrays["velocities"][gd.name][k]))
        meta = snap_mod.load_orbax_meta(path)
        snap_mod.restore(self.workflow,
                         {**meta, "units": {}, "velocities": {}})
        return meta

    def _local_idx(self, mat: np.ndarray) -> np.ndarray:
        """The (k, n) columns of the (k, B) index matrix that this rank's
        data coordinate takes (the matrix itself off a mesh)."""
        if self._dp == 1:
            return mat
        self._global_batch = int(np.shape(mat)[1])
        return mesh_mod.shard_index_rows(mat, self._dp, self._d)

    def _local_row(self, idx):
        """This rank's part of one index row (numpy or a tensor)."""
        if self._dp == 1:
            return idx
        if isinstance(idx, torch.Tensor):
            return torch.from_numpy(self._local_idx(
                idx.cpu().numpy()[None])[0]).to(idx.device)
        return self._local_idx(np.asarray(idx)[None])[0]

    def _own_rows(self, t: torch.Tensor, n: int, fill=1) -> torch.Tensor:
        """Rows ``[d·n, (d+1)·n)`` of a tensor drawn at the global batch,
        padded with ``fill`` past its end."""
        row0 = self._d * n
        part = t[row0:row0 + n]
        if part.shape[0] < n:
            pad = torch.full((n - part.shape[0],) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=t.device)
            part = torch.cat([part, pad])
        return part

    def _global_rows(self, n: int) -> int:
        return (self._global_batch if self._global_batch is not None
                else self._dp * n)

    def _sum_over_data(self, *tensors) -> list:
        """The tensors summed over the ``data`` group (as they are off a
        mesh)."""
        return mesh_mod.sum_over(tensors, self._data_group)

    def extract_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{module name: {"weights": tensor, "bias": tensor}}``, the live
        parameters (the reference's tree layout); on a mesh, this rank's
        rows of a column-sharded one (``snapshotter.collect`` gathers
        them whole)."""
        return {f.name: self._params_of(f) for f in self._weighted()}

    def extract_velocities(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The momentum state in the same layout (zeros until trained)."""
        self._init_velocities()
        return {f.name: dict(self.gd_of[f.name].velocities)
                for f in self._weighted() if f.name in self.gd_of}

    def hypers(self):
        """``{module name: (lr, lr_bias, wd, wd_bias, l1_vs_l2, moment,
        moment_bias, clip)}`` as float32."""
        return {f.name: self.gd_of[f.name].hypers()
                for f in self._weighted() if f.name in self.gd_of}

    def tiled_hypers(self, k: int) -> Dict[str, np.ndarray]:
        """``{module name: (k, 8) float32}``: the rows of a k-step segment
        whose hyperparameters do not change."""
        return {name: np.tile(np.asarray(t, np.float32), (k, 1))
                for name, t in self.hypers().items()}

    def _hypers_rows(self, k: int,
                     advance_last: bool = True) -> Dict[str, np.ndarray]:
        """The rows of a k-step segment, ``lr_adjust`` advanced after each
        row, as it advances after each applied update; without
        ``advance_last`` not after the last row (an epoch tail whose
        update will not be applied)."""
        if self.lr_adjust is None:
            return self.tiled_hypers(k)
        rows = []
        for i in range(k):
            rows.append({name: np.asarray(t, np.float32)
                         for name, t in self.hypers().items()})
            if i < k - 1 or advance_last:
                self._advance_lr()
        return {name: np.stack([r[name] for r in rows]) for name in rows[0]}

    def _epoch_hypers(self, k: int, apply_tail: bool) -> Dict[str, np.ndarray]:
        """The rows of an epoch's k + 1 train steps, its tail's last."""
        return self._hypers_rows(k + 1, advance_last=apply_tail)

    def _hyper_matrix(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(k, M, 8) float32: the rows of the weighted modules in order."""
        return np.ascontiguousarray(np.stack(
            [rows[f.name] for f in self._weighted()], axis=1), np.float32)

    def _init_velocities(self) -> None:
        """Zero momentum (in :func:`state_dtype`) for every parameter that
        has none yet, gradients on for every parameter, and the
        parameters stored in ``master_dtype`` when it is set."""
        for f in self._weighted():
            gd = self.gd_of.get(f.name)
            if gd is None:
                raise ValueError(f"{f.name} has no gradient-descent "
                                 f"hyperparameters")
            for k, p in self._params_of(f).items():
                if self.master_dtype is not None \
                        and p.dtype != self.master_dtype:
                    p = nn.Parameter(p.detach().to(self.master_dtype))
                    setattr(f, k, p)
                p.requires_grad_(True)
                if k not in gd.velocities:
                    gd.velocities[k] = torch.zeros_like(p.detach(),
                                                        dtype=state_dtype())

    def _cast(self, t):
        """A float32 tensor cast to the compute dtype; others as they
        are."""
        return t.to(self.compute_dtype) if t.dtype == torch.float32 else t

    @contextlib.contextmanager
    def _compute_params(self, modules=None):
        """Within it, each parameter of ``modules`` (default every
        weighted module) stored in another dtype than the compute dtype
        reads as its cast to it (the reference's ``cparams``; under
        float32 compute, bf16-stored parameters widen as jax promotes
        them), autograd reaching the stored one through the cast."""
        swapped = []
        try:
            for f in (self._weighted() if modules is None
                      else [m for m in modules if m.has_weights]):
                for k, p in self._params_of(f).items():
                    if p.dtype != self.compute_dtype:
                        f._parameters[k] = p.to(self.compute_dtype)
                        swapped.append((f, k, p))
            yield
        finally:
            for f, k, p in swapped:
                f._parameters[k] = p

    # -- the forward -----------------------------------------------------------

    def default_mask(self, step: int, index: int, shape, ratio: float):
        gen = prng.get("fused_trainer").torch_generator(step, index,
                                                        self.device)
        return DropoutForward.make_mask(gen, shape, ratio)

    def default_offsets(self, step: int, index: int, probs):
        gen = prng.get("fused_trainer").torch_generator(step, index,
                                                        self.device)
        return StochasticPoolingBase.sample_offsets(probs, gen)

    def _decode(self, data):
        """uint8 data decodes to ``u8 * scale + shift`` on the device; any
        other dtype passes through."""
        if data.dtype == torch.uint8:
            scale, shift = self._decode_params
            data = data.to(torch.float32) * scale + shift
        return data

    def forward_pass(self, x, train: bool = False, step: int = 0,
                     cast: Optional[Callable] = None,
                     mask_fn: Optional[MaskFn] = None,
                     remat: bool = False):
        """The last module's output (LOGITS for a softmax head) for an
        NHWC batch ``x``; ``train`` applies the dropout masks of train
        step ``step`` (from ``mask_fn``, default :attr:`mask_fn`);
        ``cast`` re-casts the activation entering every module (mixed
        precision).  With ``remat`` each block of :meth:`blocks` runs
        under its own non-reentrant ``torch.utils.checkpoint`` and reads
        its parameters in the compute dtype inside it, so the backward
        keeps only the blocks' inputs and recomputes one block at a
        time."""
        masks = mask_fn or self.mask_fn
        if self.mesh is not None:
            masks = self._rank_masks(masks)
        plan = plan_fused_blocks(self.forwards)
        tail_plan = plan_fused_tail(self.forwards, plan)

        def run(lo, hi, h):
            i = lo
            while i < hi:
                h, i = self._layer(i, h, x.shape[0], train, step, cast,
                                   masks, plan, tail_plan)
            return h

        def run_remat(lo, hi, h):
            with self._compute_params(self.forwards[lo:hi]):
                return run(lo, hi, h)

        if not remat:
            return run(0, len(self.forwards), x)
        from torch.utils.checkpoint import checkpoint

        h = x
        for lo, hi in self.blocks(plan, tail_plan):
            h = checkpoint(run_remat, lo, hi, h, use_reentrant=False,
                           preserve_rng_state=False)
        return h

    def blocks(self, plan=None, tail_plan=None) -> List[Tuple[int, int]]:
        """The forwards as ``[(first, end)]`` blocks, the pieces ``remat``
        checkpoints one by one: a block starts at each module with
        weights and takes the modules without weights after it (a
        convolution with its activation, LRN and pool; an FC layer with
        its dropout); a fused span never straddles two blocks."""
        if plan is None:
            plan = plan_fused_blocks(self.forwards)
        if tail_plan is None:
            tail_plan = plan_fused_tail(self.forwards, plan)
        out: List[Tuple[int, int]] = []
        i = 0
        while i < len(self.forwards):
            span = (plan[i].span if i in plan
                    else tail_plan[i].span if i in tail_plan else 1)
            if not out or self.forwards[i].has_weights:
                out.append((i, i + span))
            else:
                out[-1] = (out[-1][0], i + span)
            i += span
        return out

    def _layer(self, i, h, rows, train, step, cast, masks, plan, tail_plan):
        """Module ``i`` (or the fused span starting there) applied to
        ``h``: (its output, the index after the span)."""
        f = self.forwards[i]
        if cast is not None:
            h = cast(h)
        blk = plan.get(i)
        if blk is not None:
            return (fused_block(f.apply_linear(h), f.bias, blk.n, blk.alpha,
                                blk.beta, blk.k, blk.pool), i + blk.span)
        tl = tail_plan.get(i)
        if tl is not None:
            if tl.kind == "conv_bias_relu":
                return fused_bias_relu(f.apply_linear(h), f.bias), i + tl.span
            if tl.kind == "seq_epilogue":
                y = seq_linear(h, f.weights,
                               weights_transposed=f.weights_transposed)
                return fused_fc_epilogue(y, f.bias), i + tl.span
            place = mesh_mod.placement_of(f)                # fc_epilogue
            if place is not None:
                h = mesh_mod.copy_to_model(h, self.mesh)
            y = linear(h, f.weights, weights_transposed=f.weights_transposed)
            mask_of = None
            if train and tl.dropout_index >= 0 and tl.ratio > 0.0:
                extra = {} if place is None else {
                    "cols": self._own_cols(y.shape[1])}

                def mask_of(shape=tuple(y.shape), tl=tl, kw=extra):
                    return masks(step, tl.dropout_index, shape, tl.ratio,
                                 **kw)
            h = fused_fc_epilogue(y, f.bias, mask_of)
            if place is not None:
                h = mesh_mod.gather_columns(h, self.mesh)
            return h.reshape((rows,) + f.output_sample_shape), i + tl.span
        if isinstance(f, DropoutForward):
            if train:
                h = h * masks(step, i, tuple(h.shape), f.dropout_ratio)
        elif isinstance(f, StochasticPoolingBase) and train:
            with torch.no_grad():
                probs = f.probabilities(f.windows(h, f.PAD_VALUE))
            if self._dp > 1:
                off = self._own_rows(self.offset_fn(
                    step, i, self._at_global_rows(probs)),
                    probs.shape[0], fill=0)
            else:
                off = self.offset_fn(step, i, probs)
            h = f.select_sampled(h, off.to(h.device))
        elif mesh_mod.placement_of(f) is not None:
            h = self._sharded_fc(f, h, logits=f is self.forwards[-1])
        elif f is self.forwards[-1] and isinstance(f, All2AllSoftmax):
            h = linear(h, f.weights, f.bias,
                       weights_transposed=f.weights_transposed)
            h = h.reshape((rows,) + f.output_sample_shape)
        elif f is self.forwards[-1] and isinstance(f, SeqAll2AllSoftmax):
            h = seq_linear(h, f.weights, f.bias,
                           weights_transposed=f.weights_transposed)
        else:
            h = f(h)
        return h, i + 1

    def _rank_masks(self, masks: MaskFn):
        """``masks`` drawn at the global batch (and, with ``cols``, at a
        column-sharded layer's whole width), cut to this rank's rows (and
        ``cols`` = (first, end, width) columns)."""
        def rank_mask(step, index, shape, ratio, cols=None):
            n = shape[0]
            rest = tuple(shape[1:]) if cols is None else (cols[2],)
            m = self._own_rows(
                masks(step, index, (self._global_rows(n),) + rest, ratio), n)
            return m if cols is None else m[:, cols[0]:cols[1]]
        return rank_mask

    def _own_cols(self, cols: int) -> Tuple[int, int, int]:
        """(first, end, whole width) of this rank's ``cols`` columns of a
        column-sharded layer."""
        r = mesh_mod.axis_index(self.mesh, "model")
        mp = mesh_mod.axis_size(self.mesh, "model")
        return r * cols, (r + 1) * cols, mp * cols

    def _at_global_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` placed at their global positions of a
        tensor of ones (what a draw at the global shape reads)."""
        n = t.shape[0]
        g = torch.ones((self._global_rows(n),) + tuple(t.shape[1:]),
                       dtype=t.dtype, device=t.device)
        row0 = self._d * n
        real = max(0, min(n, g.shape[0] - row0))
        g[row0:row0 + real] = t[:real]
        return g

    def _sharded_fc(self, f, h, logits: bool):
        """A column-sharded FC module: its input through
        ``copy_to_model``, this rank's rows of the product, their
        activation, the columns gathered; a softmax activates the whole,
        and as the head (``logits``) not at all."""
        softmax = isinstance(f, All2AllSoftmax)
        y = linear(mesh_mod.copy_to_model(h, self.mesh), f.weights, f.bias)
        if not softmax:
            y = type(f).ACTIVATION(y)
        y = mesh_mod.gather_columns(y, self.mesh)
        if softmax and not logits:
            y = type(f).ACTIVATION(y)
        return y.reshape((h.shape[0],) + f.output_sample_shape)

    # -- loss, steps -----------------------------------------------------------

    def loss_and_metrics(self, data, target, batch_size: int, step: int,
                         train: bool, mask_fn: Optional[MaskFn] = None):
        """``(loss, (loss, n_err, confusion))`` of a minibatch whose first
        ``batch_size`` rows are valid.  A softmax head's loss is the mean
        softmax-CE of those rows, through the fused head under
        ``fused_tail``; an MSE head's is ``0.5 * sum((y - t)^2) / rows``
        over them, with n_err 0 and a (1, 1) confusion.  The forward runs
        in the compute dtype, the loss in float32; under :attr:`remat` a
        train forward is recomputed in the backward, block by block
        (:meth:`blocks`)."""
        cast = None if self.compute_dtype == torch.float32 else self._cast

        if cast is not None:
            data = cast(data)
        if self.remat and train and torch.is_grad_enabled():
            out = self.forward_pass(data, train, step, cast, mask_fn,
                                    remat=True).float()
        else:
            with self._compute_params():
                out = self.forward_pass(data, train, step, cast,
                                        mask_fn).float()
        n = out.shape[0]
        # on a mesh, the global position of each of this rank's rows
        valid = torch.arange(self._d * n, self._d * n + n,
                             device=out.device) < batch_size
        denom = max(int(batch_size), 1)
        if self.loss_kind == "mse":
            diff = (out.reshape(n, -1) - target.reshape(n, -1)) \
                * valid[:, None]
            loss = 0.5 * torch.sum(torch.square(diff)) / denom
            return loss, (loss.detach(),
                          torch.zeros((), dtype=torch.int64,
                                      device=out.device),
                          torch.zeros((1, 1), dtype=torch.int32,
                                      device=out.device))
        logits = out
        if logits.ndim == 3:
            # a sequence head: every token of a valid row is one
            # classification, the loss a mean per token
            # (EvaluatorSeqSoftmax flattens the same way)
            t = logits.shape[1]
            logits = logits.reshape(n * t, logits.shape[-1])
            target = target.reshape(n * t)
            valid = valid.repeat_interleave(t)
            denom = max(int(batch_size) * t, 1)
        if bool(root.common.engine.get("fused_tail", False)):
            loss = fused_softmax_xent(logits, target, valid, denom)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, 1, target[:, None])[:, 0]
            loss = torch.sum(torch.where(valid, logz - ll, 0.0)) / denom
        pred = torch.argmax(logits, dim=-1)
        n_err = torch.sum((pred != target) & valid)
        conf = confusion(pred, target, valid,
                         logits.shape[-1] if self.compute_confusion else 0)
        return loss, (loss.detach(), n_err, conf)

    def _minibatch(self, idx):
        """(decoded data rows, target rows) of the index row ``idx``
        (numpy or a tensor on the device): the labels for a softmax head,
        the loader's targets for an MSE one."""
        data, target = self.loader.gather(idx)
        if self.loss_kind == "mse":
            target = self.loader.gather_targets(idx, data)
        return self._decode(data), target

    def _batch(self, inputs: Dict[str, torch.Tensor]):
        """(decoded data, targets) of one step's inputs: an index row
        (``idx``) into the resident dataset, or staged rows (``data``,
        ``target``)."""
        if "idx" in inputs:
            return self._minibatch(inputs["idx"])
        return self._decode(inputs["data"]), inputs["target"]

    def _update(self, grads, hyp, clips) -> None:
        """``sgd_update`` of every parameter in place, module ``m``'s
        hyperparameters from ``hyp[m]`` (a (M, 8) float32 tensor on the
        device); the clip, which decides a branch, from the host's
        ``clips``."""
        leaves = [(m, f.name, k, p) for m, f in enumerate(self._weighted())
                  for k, p in self._params_of(f).items()]
        with torch.no_grad():
            for (m, name, k, p), g in zip(leaves, grads):
                lr, lrb, wd, wdb, l1l2, mom, momb, _ = hyp[m].unbind()
                is_bias = k == "bias"
                v = self.gd_of[name].velocities[k]
                # float32 arithmetic; a bf16-stored parameter is widened,
                # updated and rounded back by the copy
                w = p if self.master_dtype is None else p.float()
                w_new, v_new = sgd_update(
                    w, g.float(), v, lr=lrb if is_bias else lr,
                    weights_decay=wdb if is_bias else wd, l1_vs_l2=l1l2,
                    momentum=momb if is_bias else mom, clip=clips[m])
                p.copy_(w_new)
                v.copy_(v_new)

    def _step(self, kind: str, inputs, batch_size: int, step: int,
              hyp=None, clips=(), mask_fn: Optional[MaskFn] = None):
        """One step on ``inputs``: ``train`` (forward, autograd, the
        update; the metrics), ``eval`` (metrics only) or ``tail`` (metrics
        of the train forward with step ``step``'s masks)."""
        data, target = self._batch(inputs)
        if kind != "train":
            with torch.no_grad():
                _, metrics = self.loss_and_metrics(
                    data, target, batch_size, step, kind == "tail", mask_fn)
            return metrics
        loss, metrics = self.loss_and_metrics(data, target, batch_size,
                                              step, True, mask_fn)
        params = [p for f in self._weighted()
                  for p in self._params_of(f).values()]
        grads = mesh_mod.sum_gradients(torch.autograd.grad(loss, params),
                                       self._data_group)
        self._update(grads, hyp, clips)
        return metrics

    def _put(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the trainer's device, the host not waiting for
        the card: on the card through pinned memory, the copy queued on
        the current stream (the caching host allocator keeps the pinned
        block until that copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host_row(self) -> Tuple[torch.Tensor, tuple]:
        """The current hyperparameters as a (M, 8) row on the device, and
        the clips."""
        mat = self._hyper_matrix(self.tiled_hypers(1))[0]
        return self._put(mat), tuple(float(c) for c in mat[:, 7])

    def train_step(self, idx, batch_size: int, step: int):
        """Forward, autograd, and the update of every parameter with the
        current hyperparameters; returns the step's metrics."""
        self._init_velocities()
        hyp, clips = self._host_row()
        metrics = self._step("train", {"idx": self._local_row(idx)},
                             batch_size, step, hyp, clips)
        self.stats["train_steps"] += 1
        return tuple(self._sum_over_data(*metrics))

    def eval_step(self, idx, batch_size: int, step: int = 0,
                  train: bool = False):
        """Metrics only.  ``train`` replays the train forward with the
        dropout masks of ``step`` (the epoch tail)."""
        metrics = self._step("tail" if train else "eval",
                             {"idx": self._local_row(idx)}, batch_size, step)
        self.stats["eval_steps"] += 1
        return tuple(self._sum_over_data(*metrics))

    # -- captured steps -------------------------------------------------------

    def _captured(self) -> bool:
        return (self.device.type == "cuda" and self.scan_chunk > 1
                and self.uncaptured_reason is None)

    def _capture_key(self, kind, inputs, batch_size, clips) -> tuple:
        eng = root.common.engine
        return (kind, int(batch_size), clips, self.remat,
                tuple(repr(eng.get(k, None)) for k in ENGINE_DEFAULTS),
                tuple((n, tuple(t.shape), t.dtype)
                      for n, t in sorted(inputs.items())))

    def _dispatch(self, kind: str, inputs, batch_size: int, step: int,
                  hyp=None, clips=()):
        """One train or eval step of a segment: a replay of its key's
        capture; the key's first step runs eagerly on the capture stream
        and is then captured.  Uncaptured (the CPU, ``scan_chunk`` 1, the
        stochastic pooling rule) it runs as it is."""
        if not self._captured():
            self.stats["eager_steps"] += 1
            return self._step(kind, inputs, batch_size, step, hyp, clips)
        key = self._capture_key(kind, inputs, batch_size, clips)
        cap = self._captures.get(key)
        if cap is not None:
            for name, t in inputs.items():
                cap.inputs[name].copy_(t)
            if hyp is not None:
                cap.hyp.copy_(hyp)
            for index, (buf, shape, ratio) in cap.masks.items():
                buf.copy_(self.mask_fn(step, index, shape, ratio))
            cap.replay()
            self.stats["captured_steps"] += 1
            return cap.outputs
        masks = {}
        t0 = time.perf_counter()

        def record(step_, index, shape, ratio):
            mask = self.mask_fn(step_, index, shape, ratio)
            masks[index] = (torch.empty_like(mask, device=self.device),
                            tuple(shape), ratio)
            return mask

        current = torch.cuda.current_stream(self.device)
        with capturing(self.device) as stream:
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = self._step(kind, inputs, batch_size, step, hyp, clips,
                                 record)
            current.wait_stream(stream)
            for t in out:
                t.record_stream(current)
            self.stats["eager_steps"] += 1
            # nothing else may touch the card while it captures: the
            # stager's assemblies and the snapshot writer finish first
            if self._stager is not None:
                self._stager.quiesce()
            self._drain_snapshots(suppress=False)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            cap = StepGraph({n: torch.empty_like(t)
                             for n, t in inputs.items()},
                            None if hyp is None else torch.empty_like(hyp),
                            masks)
            cap.capture(lambda: self._step(kind, cap.inputs, batch_size, 0,
                                           cap.hyp, clips, cap.mask), stream)
        self._captures[key] = cap
        self.stats["warmup_s"] += t1 - t0
        self.stats["capture_s"] += time.perf_counter() - t1
        return out

    # -- segments -------------------------------------------------------------

    def _segment(self, kind: str, inputs, sizes, step0: int = 0,
                 hyp_rows=None):
        """k ``train`` or ``eval`` steps on the segment's ``inputs`` (each
        a (k, ...) tensor on the device), a train segment's
        hyperparameters from ``hyp_rows`` ((k, M, 8) on the host, copied
        once).  Returns the (k,) losses and n_err on the device and the
        confusion summed over the segment."""
        k = len(sizes)
        hyp = None if hyp_rows is None else self._put(hyp_rows)
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        n_errs = torch.empty(k, dtype=torch.int64, device=self.device)
        conf = None
        for i in range(k):
            row, clips = ((None, ()) if hyp is None else
                          (hyp[i], tuple(float(c) for c in hyp_rows[i, :, 7])))
            loss, n_err, c = self._dispatch(
                kind, {n: t[i] for n, t in inputs.items()}, sizes[i],
                step0 + i, row, clips)
            losses[i].copy_(loss)
            n_errs[i].copy_(n_err)
            conf = c.clone() if conf is None else conf.add_(c)
        self.segments[(kind, k)] += 1
        return losses, n_errs, conf

    def _resident_inputs(self, seg) -> Dict[str, torch.Tensor]:
        """A segment's index rows as one (k, B) tensor on the device (on a
        mesh, this rank's (k, n) columns)."""
        mat = np.stack([np.asarray(s["idx"], np.int64) for s in seg])
        return {"idx": self._put(self._local_idx(mat))}

    def _stage_direct(self, idx_rows) -> StagedSegment:
        """Assemble one segment's rows: the host gather in the storage
        dtype (into pinned memory on the card) of this rank's rows only
        on a mesh (:meth:`_local_idx`), the copy to the device (on the
        copy stream, with its event).  Under ``staging_donate`` the copy
        writes a buffer a consumed segment gave back, where one of the
        shape is free."""
        loader = self.loader
        idx = self._local_idx(
            np.stack([np.asarray(r, np.int32) for r in idx_rows]))
        k, batch = idx.shape
        flat = idx.reshape(-1)
        if self.loss_kind == "softmax":
            tgt = loader.host_gather_labels(flat).astype(np.int64)
            tgt = tgt.reshape(k, batch)
        else:
            tgt = loader.host_gather_targets(flat)
            tgt = tgt.reshape((k, batch) + tgt.shape[1:])
        shape = (k, batch) + loader.sample_shape
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            dtype = torch.from_numpy(np.zeros(0, loader.source.dtype)).dtype
            pin_d, host = self._pinned.take(shape, dtype)
            loader.host_gather(flat, out=host.numpy().reshape(
                (k * batch,) + loader.sample_shape))
            pin_t, host_t = self._pinned.take(
                tgt.shape, torch.from_numpy(tgt[:0]).dtype)
            host_t.numpy()[...] = tgt
        else:
            host = torch.from_numpy(loader.host_gather(flat).reshape(shape))
            host_t = torch.from_numpy(tgt)
        t1 = time.perf_counter()
        stream = self._copy_stream
        donate = bool(root.common.engine.get("staging_donate", True))
        with (torch.cuda.stream(stream) if cuda
              else contextlib.nullcontext()):
            bufs = []
            for t in (host, host_t):
                buf = (self.staging_buffers.take(t.shape, t.dtype,
                                                 self.device, stream)
                       if donate else
                       torch.empty(t.shape, dtype=t.dtype, device=self.device))
                buf.copy_(t, non_blocking=cuda)
                bufs.append(buf)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(stream)
                self._pinned.give_back(ready, pin_d, pin_t)
        with self._stats_lock:
            self.stats["stage_gather_s"] += t1 - t0
            self.stats["stage_copy_s"] += time.perf_counter() - t1
        return StagedSegment(bufs[0], bufs[1], ready)

    def _consumed(self, seg: StagedSegment) -> None:
        """A staged segment whose reads are all queued: its buffers go
        back to the free list under ``staging_donate``."""
        if bool(root.common.engine.get("staging_donate", True)):
            self.staging_buffers.give_back(seg.data, seg.target)

    # -- the epoch loop --------------------------------------------------------

    def _feed_decision(self, mb, metrics) -> None:
        loss, n_err, conf = metrics
        d = self.decision
        d.minibatch_class = mb["class"]
        d.last_minibatch = mb["last_minibatch"]
        d.class_ended = mb["class_ended"]
        d.epoch_number = mb["epoch_number"]
        d.class_lengths = list(self.loader.class_lengths)
        d.minibatch_size = mb["size"]
        d.minibatch_loss = float(loss)
        if hasattr(d, "minibatch_n_err"):   # not DecisionMSE's
            d.minibatch_n_err = int(n_err)
            # None: summed on the device with the epoch, handed over at
            # the tail (the Decision skips it)
            d.confusion_matrix = conf
        d.run()

    def _advance(self):
        ldr = self.loader
        ldr.run()
        return {"idx": ldr.minibatch_indices, "class": ldr.minibatch_class,
                "size": ldr.minibatch_size,
                "last_minibatch": ldr.last_minibatch,
                "class_ended": ldr.class_ended,
                "epoch_number": ldr.epoch_number}

    def _reset_accounting(self) -> None:
        self._acct_seen = set()
        self._acct_last_end = None

    def _account(self, kind: str, images: int, t0: float,
                 warm: Optional[Tuple[int, float]] = None,
                 steps: int = 1, train_steps: int = 0) -> None:
        """Charge ``[max(t0, the last interval's end), now]``: with the
        one-deep flush a segment is read back while the next iteration
        runs, whose own ``t0`` came before, so plain ``now - t0``
        intervals would overlap and count time twice.  ``warm``, the deep
        pipeline's (images, seconds) after its first epoch on the
        device's clock, replaces the warm figures: the card runs queued
        epochs while the host reads earlier ones, so a host interval would
        be credited with work done in the one before.  ``steps`` of the
        interval (``train_steps`` of them TRAIN minibatches, whose images
        are ``images``) feed the trainer's telemetry."""
        now = time.perf_counter()
        start = t0 if self._acct_last_end is None \
            else max(t0, self._acct_last_end)
        dt = max(now - start, 1e-9)
        self._acct_last_end = now
        if self._tracer.enabled:
            self._m_step_seconds.observe(dt / max(steps, 1))
        if train_steps:
            self._m_train_steps.inc(train_steps)
            self._m_images.inc(images)
        st = self.stats
        st["wall_s"] += dt
        st["images"] += images
        st["img_per_sec"] = st["images"] / st["wall_s"]
        if warm is not None:
            st["warm_images"], st["warm_wall_s"] = warm
        elif kind in self._acct_seen:
            st["warm_wall_s"] += dt
            st["warm_images"] += images
        if st["warm_wall_s"] > 0:
            st["warm_img_per_sec"] = st["warm_images"] / st["warm_wall_s"]
        self._acct_seen.add(kind)

    def _advance_lr(self) -> None:
        if self.lr_adjust is not None:
            self.lr_adjust.run()

    def _async_snapshot_enabled(self, snap) -> bool:
        """Whether ``snap`` saves on its background writer: a host-format
        snapshotter under ``async_snapshot``; an orbax save is a
        collective and stays synchronous."""
        return (snap is not None and snap.format != "orbax"
                and bool(root.common.engine.get("async_snapshot", True)))

    def _drain_snapshots(self, suppress: bool) -> None:
        """Wait until the queued background saves are written; with
        ``suppress`` (an error already in flight) a writer's error is not
        raised over it."""
        snap = getattr(self.workflow, "snapshotter", None)
        if snap is None or not hasattr(snap, "flush_async"):
            return
        try:
            snap.flush_async()
        except Exception:
            if not suppress:
                raise

    def _epoch_end(self) -> None:
        """The workflow's snapshotter (:meth:`_snapshot_epoch_end`), then
        its plotters, after a :meth:`writeback`: each reads the epoch's
        last parameters."""
        self._snapshot_epoch_end()
        plotters = list(getattr(self.workflow, "plotters", None) or [])
        if plotters:
            self.writeback()
            for plotter in plotters:
                plotter.run()

    def writeback(self) -> None:
        """Make the parameters readable as the last step left them.  The
        modules the units hold are the trainer's state (a step updates
        them in place, a graph replay writes the tensors it captured), so
        nothing is copied: the host only waits out the work queued on
        the card, on every stream, before a reader pulls a parameter."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _snapshot_epoch_end(self) -> None:
        """The workflow's snapshotter, unless it is gated off: a due save
        is queued for the background writer with device clones of the
        state under ``async_snapshot``, else written in line."""
        snap = getattr(self.workflow, "snapshotter", None)
        if snap is None or bool(snap.gate_skip):
            return
        decision = self.decision
        snap.epoch_number = decision.epoch_number
        snap.improved = decision.improved
        if not self._async_snapshot_enabled(snap):
            snap.run()
            return
        tags = snap.tags_for(decision.epoch_number, decision.improved)
        if tags:
            from znicz_torch import snapshotter as snap_mod

            state = snap_mod.collect(self.workflow, device_copies=True)
            state["config"] = root.to_dict()
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            snap.save_async(state, tags, ready)

    def run(self) -> None:
        """Train until the Decision completes: the deep pipeline under
        ``pipeline_depth`` above 1 where :meth:`_deep_eligible`, else the
        segmented run.  The final background snapshot is written before
        it returns."""
        if self.loader is None:
            raise ValueError("the workflow has no loader to train from")
        if self.loss_kind != "softmax" and \
                getattr(self.loader, "streaming", False) and \
                self.loader.original_targets is None:
            raise ValueError(
                f"{self.loader.name}: a streaming loader under an MSE loss "
                "needs regression targets (build its source with "
                "targets=)")
        self._init_velocities()
        self._reset_accounting()
        coll0 = dict(mesh_mod.STATS)
        indices_only, self.loader.indices_only = self.loader.indices_only, True
        try:
            if self.pipeline_depth > 1 and self._deep_eligible():
                self._run_deep()
            else:
                self._run_segmented()
        finally:
            self.loader.indices_only = indices_only
            self._captures.clear()
            self.staging_buffers.clear()
            self._pinned.clear()
            if self._stager is not None:
                self.stager_stats = self._stager.stats()
                self._stager.close()
                self._stager = None
            # an interrupted run still lands its queued saves, without a
            # writer's error hiding the one in flight
            self._drain_snapshots(suppress=sys.exc_info()[0] is not None)
            for key, stat in (("collectives", "calls"),
                              ("collective_bytes", "bytes"),
                              ("collective_s", "seconds")):
                self.stats[key] += mesh_mod.STATS[stat] - coll0[stat]

    def _run_segmented(self) -> None:
        loader, decision = self.loader, self.decision
        staging = self.staging
        fifo = deque()              # advanced, not yet dispatched
        inflight = None             # (segment, device metrics, t0)
        epoch_conf = None           # the epoch's confusion, on the device
        eng = root.common.engine
        if staging and self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device=self.device)
        prefetch_segments = int(eng.get("prefetch_segments", 2))
        can_prefetch = (staging and prefetch_segments > 0 and
                        getattr(loader.source, "prefetch", None) is not None)
        stager = None
        if staging and bool(eng.get("async_staging", True)):
            from znicz_torch.loader.ingest import DeviceStager

            stager = self._stager = DeviceStager(self._stage_direct)
        # the lookahead also feeds the stager's predictions for sources
        # without a decode pool
        look_mbs = max(prefetch_segments * self.scan_chunk
                       if can_prefetch else 0,
                       2 * self.scan_chunk if stager else 0)

        def segment_inputs(seg):
            """(the staged segment or None, the segment's (k, ...) inputs
            on the device)."""
            if not staging:
                return None, self._resident_inputs(seg)
            rows = [s["idx"] for s in seg]
            self.stats["staged_segments"] += 1
            staged = (stager.take(rows) if stager is not None
                      else self._stage_direct(rows))
            return staged, staged.consume()

        def consumed(staged):
            if staged is not None:
                self._consumed(staged)

        def upcoming_segments():
            """The groups the loop will form from the fifo, by its rules,
            up to the first whose end the fifo cannot show yet."""
            groups, i, n = [], 0, len(fifo)
            while i < n:
                m = fifo[i]
                if m["class"] == TRAIN and m["last_minibatch"]:
                    groups.append([m])
                    i += 1
                    continue
                is_train = m["class"] == TRAIN
                seg = [m]
                i += 1
                while i < n and len(seg) < self.scan_chunk:
                    nxt = fifo[i]
                    same = (nxt["class"] == TRAIN
                            and not nxt["last_minibatch"]
                            if is_train else nxt["class"] == m["class"])
                    if not same:
                        break
                    seg.append(nxt)
                    i += 1
                if len(seg) < self.scan_chunk and i >= n:
                    break
                groups.append(seg)
            return groups

        def submit_upcoming():
            if stager is None:
                return
            for seg in upcoming_segments():
                if stager.outstanding >= stager.depth:
                    break
                stager.submit([s["idx"] for s in seg])

        def take_mb():
            return fifo.popleft() if fifo else self._advance()

        def extend_lookahead():
            if not look_mbs:
                return
            if can_prefetch:
                for m in fifo:
                    if not m.get("pf"):
                        loader.prefetch_rows(self._local_row(m["idx"]))
                        m["pf"] = True
            # never past an epoch's tail: the snapshot at the epoch's end
            # records the loader as the tail left it
            while len(fifo) < look_mbs and \
                    not (fifo and fifo[-1]["last_minibatch"]):
                nxt = self._advance()
                if can_prefetch:
                    loader.prefetch_rows(self._local_row(nxt["idx"]))
                    nxt["pf"] = True
                fifo.append(nxt)

        def collect(first, same):
            seg = [first]
            while len(seg) < self.scan_chunk:
                nxt = take_mb()
                if not same(nxt):
                    fifo.appendleft(nxt)
                    break
                seg.append(nxt)
            return seg

        def flush():
            """Read back the in-flight train segment and feed its metrics,
            after the next segment is queued; its confusion joins the
            epoch's sum on the device."""
            nonlocal inflight, epoch_conf
            if inflight is None:
                return
            seg, result, t0 = inflight
            inflight = None
            t_flush = time.perf_counter()
            losses, n_errs, conf = self._sum_over_data(*result)
            epoch_conf = conf if epoch_conf is None else epoch_conf + conf
            losses, n_errs = losses.tolist(), n_errs.tolist()
            if self._tracer.enabled:
                # the host sync: waiting out the segment's device work and
                # reading its metrics
                self._tracer.add("train", "flush", t_flush,
                                 time.perf_counter() - t_flush,
                                 {"steps": len(seg)})
            for s, loss, n_err in zip(seg, losses, n_errs):
                self._feed_decision(s, (loss, n_err, None))
            self._account(f"train_{len(seg)}",
                          sum(s["size"] for s in seg), t0,
                          steps=len(seg), train_steps=len(seg))

        while not bool(decision.complete):
            t_iter = time.perf_counter()
            mb = take_mb()
            if mb["class"] == TRAIN and not mb["last_minibatch"]:
                seg = collect(mb, lambda m: m["class"] == TRAIN
                              and not m["last_minibatch"])
                extend_lookahead()
                if stager is not None:
                    # the upcoming segments assemble while the previous
                    # one is read back
                    submit_upcoming()
                    flush()
                hyp_rows = self._hyper_matrix(self._hypers_rows(len(seg)))
                staged, inputs = segment_inputs(seg)
                # a named profiler range and a dispatch span around the
                # segment's dispatch (host time: the device's lands in
                # the flush)
                t_disp = time.perf_counter()
                step0 = self.steps_done
                with telemetry.step_annotation(step0):
                    result = self._segment("train", inputs,
                                           [s["size"] for s in seg],
                                           step0, hyp_rows)
                if self._tracer.enabled:
                    self._tracer.add(
                        "train", "dispatch:scan" if len(seg) > 1
                        else "dispatch:single", t_disp,
                        time.perf_counter() - t_disp,
                        {"steps": len(seg), "step0": step0})
                self.stats["train_steps"] += len(seg)
                consumed(staged)
                self.steps_done += len(seg)
                submit_upcoming()
                if stager is None:
                    flush()
                inflight = (seg, result, t_iter)
            elif mb["class"] == TRAIN:
                flush()
                # the epoch tail: metrics, the Decision, then the update
                # if gd_skip stayed open
                staged, inputs = segment_inputs([mb])
                inputs = {n: t[0] for n, t in inputs.items()}
                loss, n_err, conf = self._sum_over_data(*self._step(
                    "tail", inputs, mb["size"], self.steps_done))
                self.stats["eval_steps"] += 1
                self.stats["eager_steps"] += 1
                if epoch_conf is not None:
                    conf = epoch_conf + conf
                    epoch_conf = None
                self._feed_decision(mb, (loss, n_err, conf))
                if not bool(decision.gd_skip):
                    hyp, clips = self._host_row()
                    with telemetry.step_annotation(self.steps_done):
                        self._step("train", inputs, mb["size"],
                                   self.steps_done, hyp, clips)
                    self.stats["train_steps"] += 1
                    self.stats["eager_steps"] += 1
                    self._advance_lr()
                consumed(staged)
                self.steps_done += 1
                if self._tracer.enabled:
                    self._tracer.add("train", "tail", t_iter,
                                     time.perf_counter() - t_iter,
                                     {"epoch": int(mb["epoch_number"])})
                self._account("tail", mb["size"], t_iter, train_steps=1)
            else:
                flush()
                # TEST or VALID: one class a segment, whose confusion
                # goes to that class with its first minibatch
                seg = collect(mb, lambda m: m["class"] == mb["class"])
                extend_lookahead()
                submit_upcoming()
                staged, inputs = segment_inputs(seg)
                losses, n_errs, conf = self._sum_over_data(*self._segment(
                    "eval", inputs, [s["size"] for s in seg]))
                self.stats["eval_steps"] += len(seg)
                consumed(staged)
                for i, (s, loss, n_err) in enumerate(
                        zip(seg, losses.tolist(), n_errs.tolist())):
                    self._feed_decision(s, (loss, n_err,
                                            conf if i == 0 else None))
                if self._tracer.enabled:
                    self._tracer.add("train", "eval", t_iter,
                                     time.perf_counter() - t_iter,
                                     {"steps": len(seg),
                                      "class": int(mb["class"])})
                self._account(f"eval_{len(seg)}", 0, t_iter,
                              steps=len(seg))
            if bool(decision.epoch_ended):
                self._epoch_end()
                # consumed here: the next iteration may feed the Decision
                # nothing before this check comes round again
                decision.epoch_ended.set(False)
            if not bool(decision.complete):
                # after the epoch's hook: a snapshot records the loader
                # as the tail left it
                extend_lookahead()
                submit_upcoming()
        flush()

    # -- the deep pipeline -----------------------------------------------------

    @staticmethod
    def _snapshotter_active(snap) -> bool:
        """Whether ``snap`` may save: a plain gate set to True turns it
        off; a derived one (``~decision.epoch_ended``) opens at each
        epoch's end."""
        if snap is None:
            return False
        gate = snap.gate_skip
        return not bool(gate) or (isinstance(gate, Bool) and gate.derived)

    def _deep_eligible(self) -> bool:
        """Whether the deep pipeline may run: not on a host-staged loader
        (the segmented run stages each segment, double-buffered), not with
        plotters (they read each epoch as it ends), and with an active
        snapshotter only when it saves in the background (a flushed
        epoch's own state is queued for its writer): an orbax-format
        snapshotter, whose save is a synchronous collective, or
        ``async_snapshot`` off, keeps the segmented run, as in the
        reference."""
        wf = self.workflow
        if self.staging or getattr(wf, "plotters", None):
            return False
        snap = getattr(wf, "snapshotter", None)
        return (not self._snapshotter_active(snap)
                or self._async_snapshot_enabled(snap))

    def _collect_epoch(self) -> dict:
        """Drive the loader through one epoch: its eval classes in loader
        order (``[(class, minibatches)]``) and its TRAIN minibatches,
        the last of them the tail."""
        evals, train = [], []
        while True:
            mb = self._advance()
            if mb["class"] == TRAIN:
                train.append(mb)
                if mb["last_minibatch"]:
                    break
            elif train:
                raise RuntimeError("the deep pipeline expects the eval "
                                   "classes before TRAIN")
            elif evals and evals[-1][0] == mb["class"]:
                evals[-1][1].append(mb)
            else:
                evals.append((mb["class"], [mb]))
        return {"evals": evals, "train": train,
                "epoch_number": train[-1]["epoch_number"]}

    def _state_trees(self):
        """``({forward name: {param: tensor}}, {GD unit name: {param:
        velocity}})``, the live tensors."""
        weighted = self._weighted()
        return ({f.name: dict(self._params_of(f)) for f in weighted},
                {self.gd_of[f.name].name: dict(self.gd_of[f.name].velocities)
                 for f in weighted})

    def _cloned_state(self):
        """Device clones of :meth:`_state_trees`, and the event recorded
        after them (None on the CPU)."""
        trees = tuple({n: {k: t.detach().clone() for k, t in leaves.items()}
                       for n, leaves in tree.items()}
                      for tree in self._state_trees())
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return trees, ready

    def _load_state(self, trees) -> None:
        """Copy :meth:`_cloned_state`'s trees back into the live tensors
        (whose addresses the captured steps hold)."""
        with torch.no_grad():
            for live, saved in zip(self._state_trees(), trees):
                for n, leaves in live.items():
                    for k, t in leaves.items():
                        t.copy_(saved[n][k])

    _LOADER_FIELDS = ("_pos", "epoch_number", "last_minibatch",
                      "class_ended", "minibatch_size", "minibatch_class",
                      "minibatch_indices", "samples_served")

    def _loader_state(self) -> dict:
        """The loader's position, TRAIN order, counts and native shuffle
        stream, copied."""
        ldr = self.loader
        state = {k: getattr(ldr, k) for k in self._LOADER_FIELDS}
        state["class_samples_served"] = list(ldr.class_samples_served)
        state["shuffled_indices"] = np.array(ldr._shuffled_indices)
        rng = getattr(ldr, "_native_rng", None)
        state["native_rng"] = None if rng is None else rng.state.copy()
        return state

    def _restore_loader(self, state: dict) -> None:
        ldr = self.loader
        for k in self._LOADER_FIELDS:
            setattr(ldr, k, state[k])
        ldr.class_samples_served = list(state["class_samples_served"])
        ldr._shuffled_indices = state["shuffled_indices"].copy()
        if state["native_rng"] is not None:
            ldr._native_rng.state[...] = state["native_rng"]

    def _dispatch_epoch(self, keep_input: bool) -> dict:
        """Advance the loader through one epoch and queue its steps in the
        segmented run's order, reading nothing back: the eval classes as
        eval segments, the non-tail train steps as train segments, the
        tail's metrics, then the tail's update unless this epoch's tail
        reaches ``max_epochs`` (a stop by ``fail_iterations`` is found at
        the flush, and rolled back).  Returns the epoch's record: its
        minibatches; ``scalars``, one float32 vector on the device laid
        out as the reference's (per eval class its losses, then its
        n_err; the train losses, the train n_err, the tail's loss and
        n_err); ``confs``, its confusions stacked (one per eval class,
        then TRAIN's with the tail's); and what a rollback or a snapshot
        of it needs: the state before the tail's update, the loader, the
        prng streams and the schedule at the tail, and with
        ``keep_input`` the state the epoch started from."""
        t0 = time.perf_counter()
        lr_iter = 0 if self.lr_adjust is None else self.lr_adjust.iteration
        rec = self._collect_epoch()
        rec.update(t0=t0, lr_iter=lr_iter,
                   state_in=self._cloned_state() if keep_input else None)
        apply_tail = rec["epoch_number"] + 1 < int(self.decision.max_epochs)
        chunk = self.scan_chunk

        def segments(kind, mbs, step0=0, hyp_rows=None):
            """(losses, n_err) as float32 and the summed confusion of the
            segments of ``mbs``."""
            losses, n_errs, conf = [], [], None
            for i in range(0, len(mbs), chunk):
                seg = mbs[i:i + chunk]
                rows = None if hyp_rows is None else hyp_rows[i:i + len(seg)]
                with (telemetry.step_annotation(step0 + i)
                      if kind == "train" else contextlib.nullcontext()):
                    loss, n_err, c = self._segment(
                        kind, self._resident_inputs(seg),
                        [s["size"] for s in seg], step0 + i, rows)
                losses.append(loss)
                n_errs.append(n_err)
                conf = c if conf is None else conf + c
            if not losses:
                empty = torch.zeros(0, dtype=torch.float32,
                                    device=self.device)
                return [empty, empty], conf
            return [torch.cat(losses),
                    torch.cat(n_errs).to(torch.float32)], conf

        scalars, confs = [], []
        for _, mbs in rec["evals"]:
            vecs, conf = segments("eval", mbs)
            scalars += vecs
            confs.append(conf)
        train = rec["train"]
        k = len(train) - 1
        hyp_rows = self._hyper_matrix(self._epoch_hypers(k, apply_tail))
        step0 = self.steps_done
        vecs, conf = segments("train", train[:k], step0, hyp_rows)
        tail = train[k]
        inputs = {n: t[0] for n, t in self._resident_inputs([tail]).items()}
        loss, n_err, c = self._step("tail", inputs, tail["size"], step0 + k)
        self.stats["eager_steps"] += 1
        pre_tail = None
        if apply_tail:
            pre_tail = self._cloned_state()[0]
            with telemetry.step_annotation(step0 + k):
                self._step("train", inputs, tail["size"], step0 + k,
                           self._put(hyp_rows[k]),
                           tuple(float(x) for x in hyp_rows[k, :, 7]))
            self.stats["eager_steps"] += 1
        self.steps_done = step0 + k + 1
        scalars += vecs + [torch.stack([loss, n_err.to(torch.float32)])]
        confs.append(c if conf is None else conf + c)
        # the epoch's metrics summed over the data ranks, once
        scalars, confs = self._sum_over_data(torch.cat(scalars),
                                             torch.stack(confs))
        # the streams as a snapshot at this tail records them: those the
        # steps made (the dropout masks' stream) too
        rec.update(applied_tail=apply_tail, pre_tail=pre_tail,
                   steps_end=self.steps_done, scalars=scalars,
                   confs=confs, n_train=k + int(apply_tail),
                   n_eval=sum(len(m) for _, m in rec["evals"]) + 1,
                   loader=self._loader_state(), end=self._mark(),
                   prng={name: copy.deepcopy(s.state.bit_generator.state)
                         for name, s in prng._streams.items()})
        self.stats["deep_epochs"] += 1
        return rec

    def _mark(self):
        """Now on the device's clock: a timed event recorded on the
        current stream, or the host's clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def _seconds(a, b) -> float:
        """Seconds from :meth:`_mark` ``a`` to ``b``, both reached."""
        return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3

    def _flush_epoch(self, rec: dict, vals: np.ndarray, inflight) -> int:
        """Feed a flushed epoch's metrics (``vals``, its scalars read to
        the host) to the Decision in loader order, roll back if it stopped
        there, and queue its snapshot.  Returns its TRAIN images."""
        decision, st = self.decision, self.stats
        confs = rec["confs"]
        off = 0
        for ci, (_, mbs) in enumerate(rec["evals"]):
            n = len(mbs)
            for i, mb in enumerate(mbs):
                self._feed_decision(mb, (vals[off + i], vals[off + n + i],
                                         confs[ci] if i == 0 else None))
            off += 2 * n
        train = rec["train"]
        k = len(train) - 1
        for i, mb in enumerate(train[:k]):
            self._feed_decision(mb, (vals[off + i], vals[off + k + i], None))
        off += 2 * k
        self._feed_decision(train[k], (vals[off], vals[off + 1], confs[-1]))
        # read while the tail's epoch_ended holds: a gate wired to
        # ~epoch_ended is open only until the flag is consumed below
        snap = getattr(self.workflow, "snapshotter", None)
        snap_open = snap is not None and not bool(snap.gate_skip)
        decision.epoch_ended.set(False)
        stopped = bool(decision.complete)
        st["deep_flushes"] += 1
        st["eval_steps"] += rec["n_eval"]
        st["train_steps"] += k + int(rec["applied_tail"] and not stopped)
        if stopped:
            self._roll_back(rec, inflight)
        if snap_open:
            self._snapshot_epoch(snap, rec, inflight)
        return sum(mb["size"] for mb in train)

    def _roll_back(self, rec: dict, inflight) -> None:
        """The Decision stopped at ``rec``'s tail: undo that tail's update
        and drop the epochs queued after it, and rewind ``steps_done``,
        the ``lr_adjust`` iteration, every prng stream and the loader to
        where they stood at that tail, as the segmented run stops.  An
        epoch whose tail was not applied is the last one queued."""
        st = self.stats
        if rec["applied_tail"]:
            self._load_state(rec["pre_tail"])
            st["deep_discarded_train_steps"] += 1
            st["deep_rollbacks"] += 1
        for later in inflight:
            st["deep_discarded_train_steps"] += later["n_train"]
            st["deep_discarded_eval_steps"] += later["n_eval"]
        inflight.clear()
        self.steps_done = rec["steps_end"]
        if self.lr_adjust is not None:
            self.lr_adjust.restore_iteration(
                rec["lr_iter"] + len(rec["train"]) - 1)
        for name, state in rec["prng"].items():
            prng.get(name).state.bit_generator.state = state
        self._restore_loader(rec["loader"])

    def _snapshot_epoch(self, snap, rec: dict, inflight) -> None:
        """The flushed epoch's snapshot, what :meth:`_epoch_end` would
        queue in the segmented run: its post-epoch parameters and
        velocities (the next queued epoch's input clone, else the live
        state, cloned), the loader and prng streams as they stood at its
        tail, and the Decision as it stands."""
        from znicz_torch import snapshotter as snap_mod

        decision = self.decision
        snap.epoch_number = decision.epoch_number
        snap.improved = decision.improved
        tags = snap.tags_for(decision.epoch_number, decision.improved)
        if not tags:
            return
        trees, ready = (inflight[0]["state_in"] if inflight
                        else self._cloned_state())
        state = snap_mod.snapshot_from_trees(self.workflow, *trees)
        at_tail = rec["loader"]
        state["loader"].update(
            epoch_number=at_tail["epoch_number"],
            samples_served=at_tail["samples_served"],
            last_minibatch=bool(at_tail["last_minibatch"]),
            shuffled_indices=at_tail["shuffled_indices"].copy())
        state["prng"] = rec["prng"]
        state["config"] = root.to_dict()
        snap.save_async(state, tags, ready)

    def _run_deep(self) -> None:
        """The deep pipeline (the reference's ``_run_deep``): whole epochs
        queued back to back (:meth:`_dispatch_epoch`), the host reading
        nothing of them until ``2 * pipeline_depth`` are in flight; then
        the ``pipeline_depth`` oldest are flushed, their scalar vectors
        joined on the device and read in one transfer, and fed to the
        Decision in loader order (:meth:`_flush_epoch`).  After the epoch
        whose tail reaches ``max_epochs`` the rest are flushed in one
        transfer.  A stop found late rolls back to the segmented run's
        stopping state, bit for bit (:meth:`_roll_back`)."""
        decision, st = self.decision, self.stats
        keep_input = self._snapshotter_active(
            getattr(self.workflow, "snapshotter", None))
        inflight: deque = deque()
        # the warm figures: the epochs after the first, from its end to
        # the last flushed one's on the device's clock
        first = {"end": None, "last": None, "images": 0}

        def flush(n):
            t0 = inflight[0]["t0"]
            vals = torch.cat([inflight[i]["scalars"]
                              for i in range(n)]).cpu().numpy()
            st["deep_pulls"] += 1
            images = off = steps = train_steps = 0
            for _ in range(n):
                rec = inflight.popleft()
                size = rec["scalars"].shape[0]
                got = self._flush_epoch(rec, vals[off:off + size], inflight)
                images += got
                off += size
                train_steps += len(rec["train"])
                steps += len(rec["train"]) + rec["n_eval"] - 1
                if first["end"] is None:
                    first["end"] = rec["end"]
                else:
                    first["last"] = rec["end"]
                    first["images"] += got
                if bool(decision.complete):
                    break
            warm = None
            if first["last"] is not None:
                warm = (first["images"],
                        self._seconds(first["end"], first["last"]))
            self._account("epoch", images, t0, warm, steps=steps,
                          train_steps=train_steps)

        final = False
        while not bool(decision.complete):
            if final:
                if not inflight:
                    raise RuntimeError("the Decision did not complete at "
                                       "max_epochs")
                flush(len(inflight))
                continue
            rec = self._dispatch_epoch(keep_input)
            final = not rec["applied_tail"]
            inflight.append(rec)
            st["deep_inflight_max"] = max(st["deep_inflight_max"],
                                          len(inflight))
            if len(inflight) >= 2 * self.pipeline_depth:
                flush(self.pipeline_depth)
