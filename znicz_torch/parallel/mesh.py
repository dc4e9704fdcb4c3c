"""The training mesh on ``torch.distributed`` (port of
``znicz_tpu/parallel/mesh.py``).

JAX runs one process over many devices; PyTorch runs one process a rank.
So a mesh here is always a group of processes: a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with
named dims, each rank holding its own device.

  - ``data``: batch sharding.  Rank (d, ·) takes rows ``[d·n, (d+1)·n)``
    of each minibatch's index row, ``n = ceil(B / dp)``; the gradients
    are summed over the ``data`` group before the update.
  - ``model``: column-sharded wide FC layers.  A weight whose output rows
    are at least ``tp_threshold`` and divide by ``mp`` is split by rows
    (:func:`param_sharding`); the layer's input enters through
    :func:`copy_to_model` (identity forward, sum over ``model`` backward)
    and its output columns are gathered (:func:`gather_columns`).

Start one process a rank, call :func:`distributed_init` in each, then
:func:`make_mesh`.  A 1 × 1 mesh is None (:func:`mesh_from_axes`): the
single-device path, bit for bit.  The serving mesh
(:func:`serving_mesh_from_config`, :func:`require_batch_divisible`) is
the same kind of mesh; the served batch's scatter and the logits' gather
are ``serving/model.py``'s.  This module is the one home of the
placement rule, the per-rank row selection and the collectives the
trainer and the snapshotter call.

The sequence axis (ring attention, ``ops/attention.ring_attention``):
:func:`ring_shift` passes a block to the next rank of a group (its
gradient back to the previous one), :func:`seq_block` takes a rank's
block along T of a tensor every rank holds whole and :func:`seq_gather`
joins the blocks again.

Every collective a meshed run makes goes through :func:`_collective`,
which counts its calls, bytes and host seconds in :data:`STATS`.  On a
CUDA tensor under gloo (which copies through the host, so it waits for
the tensor anyway) the current stream is synchronised first, so the
seconds are the collective's own.
"""

from __future__ import annotations

import datetime
import math
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective waits for a lost rank before it raises
TIMEOUT_S = 120
#: seconds :func:`distributed_shutdown` waits for the freed groups' gloo
#: threads to end (a busy host can take a while to reap one)
SHUTDOWN_WAIT_S = 10.0

#: what a spec says of a leaf: ``("model", None)`` rows of a 2-D weight
#: split over ``model``, ``("model",)`` a 1-D bias split, ``()``
#: replicated (the reference's ``PartitionSpec``s, as plain tuples)
Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()

#: collectives made by this process: calls, bytes moved in, host seconds
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``; a no-op for one process.  ``coordinator`` is
    ``"host:port"`` (a TCP store, rank 0 listening) or a ``file://``
    path (a ``FileStore``).  The rank's device is ``device``, else
    ``cuda:(rank % device_count)``; with no card and no ``device`` it
    raises (pass ``device="cpu"``).  ``backend`` is "nccl" on the card
    and "gloo" on the CPU unless named ("gloo" on the card lets ranks
    share one card).  Afterwards ``backends.resolve_device(None)`` is the
    rank's device.  A collective waits at most :data:`TIMEOUT_S`.  The
    process frees its groups when it exits, before the interpreter's
    teardown (:func:`distributed_shutdown`, registered with ``atexit``)."""
    import atexit

    from znicz_torch import backends

    if not num_processes or int(num_processes) <= 1:
        return
    world, rank = int(num_processes), int(process_id)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for rank "
                               f"{rank}; pass device='cpu' to run the "
                               "ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    coordinator = str(coordinator)
    init = (coordinator if "://" in coordinator
            else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    backends.set_process_device(dev)
    atexit.unregister(distributed_shutdown)     # once a process
    atexit.register(distributed_shutdown)


def gloo_threads() -> list:
    """The names of this process's live gloo threads (``pt_gloo_*``,
    ``gloo_*``), read from ``/proc/self/task``; empty where there is no
    ``/proc``."""
    import os

    names = []
    try:
        tasks = os.listdir("/proc/self/task")
    except OSError:
        return names
    for tid in tasks:
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:         # the thread ended meanwhile
            continue
        if "gloo" in name:
            names.append(name)
    return sorted(names)


def distributed_shutdown() -> list:
    """Destroy this rank's process groups and free them here, in the
    calling thread; returns the gloo threads still alive after
    :data:`SHUTDOWN_WAIT_S` (none, once every group is freed).

    ``destroy_process_group`` only unregisters the groups.  A group that
    something still holds, as a ``DeviceMesh`` kept by a trainer in a
    reference cycle is, keeps its worker threads until the cyclic
    collector frees it, and in a process about to exit that is the
    interpreter's teardown, where freeing it may abort the process
    ("terminate called without an active exception", ROADMAP C.17).  So
    the cycles are collected, and the threads waited out, before this
    returns.  A thread names itself once it runs, so one just started
    may not be counted yet."""
    import gc

    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()
    deadline = time.monotonic() + SHUTDOWN_WAIT_S
    left = gloo_threads()
    while left and time.monotonic() < deadline:
        time.sleep(0.01)
        left = gloo_threads()
    return left


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the world, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Sequence[str] = ("data",)):
    """A ``DeviceMesh`` of the world's ranks in ``shape`` over ``axes``
    (shape None: every rank on the first axis).  The shape must cover
    the world; a world smaller than the shape raises ``ValueError``
    naming :func:`distributed_init`.  One rank without a group is None,
    the single-device path."""
    from torch.distributed.device_mesh import DeviceMesh

    from znicz_torch import backends

    world = world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(
            f"mesh shape {dict(zip(axes, shape))} needs {n} ranks, but "
            f"the world has {world}: start one process a rank and call "
            f"znicz_torch.parallel.mesh.distributed_init(coordinator, "
            f"{n}, rank) in each before building the mesh")
    if n < world:
        raise ValueError(f"mesh shape {dict(zip(axes, shape))} covers "
                         f"{n} of the world's {world} ranks: a mesh "
                         f"spans the world")
    if not dist.is_initialized():
        return None
    dev = backends.process_device()
    kind = "cuda" if dev is not None and dev.type == "cuda" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def mesh_from_axes(dp, mp, plane: str = "mesh"):
    """Validate (data, model) axis sizes and build the mesh, or None for
    the 1 × 1 default, which keeps the caller on the single-device path
    bit for bit.  ``plane`` names the config tree in the refusal."""
    dp, mp = int(dp), int(mp)
    if dp < 1 or mp < 1:
        raise ValueError(f"{plane} mesh axes must be >= 1, got "
                         f"data={dp} model={mp}")
    if dp * mp == 1:
        return None
    return make_mesh((dp, mp), ("data", "model"))


def train_mesh_from_config():
    """The training mesh of ``root.common.engine.mesh.{data,model}``,
    gated on ``root.common.engine.train_shard`` (default off: the
    single-device path whatever the mesh knobs say).  None when gated
    off or 1 × 1."""
    from znicz_torch.core.config import root

    if not root.common.engine.get("train_shard", False):
        return None
    mc = root.common.engine.mesh
    return mesh_from_axes(mc.get("data", 1), mc.get("model", 1), "training")


def serving_mesh_from_config():
    """The serving mesh of ``root.common.serving.mesh.{data,model}``, or
    None for the 1 × 1 default (the single-device path)."""
    from znicz_torch.core.config import root

    mc = root.common.serving.mesh
    return mesh_from_axes(mc.get("data", 1), mc.get("model", 1), "serving")


def require_batch_divisible(rows: int, mesh) -> int:
    """The refusal of a batch that does not split evenly over the mesh's
    ``data`` axis (a served batch is never padded per rank); returns
    dp."""
    dp = axis_size(mesh, "data")
    if int(rows) % dp:
        raise ValueError(
            f"batch of {rows} rows does not divide across the mesh's data "
            f"axis (dp={dp}); pad to a ladder rung (rungs are snapped to "
            f"multiples of dp)")
    return dp


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without one)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None
    when the axis has one rank (no collective to make)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def mesh_shape_dict(mesh) -> Optional[Dict[str, int]]:
    """``{"data": dp, "model": mp}``, None without a mesh."""
    if mesh is None:
        return None
    return {str(a): axis_size(mesh, a) for a in mesh.mesh_dim_names}


# -- placement -----------------------------------------------------------------


def param_sharding(mesh, arr, tp_threshold: int = 1024) -> Spec:
    """The one placement rule: a 2-D (out, in) weight whose ``out`` is
    at least ``tp_threshold`` and divides by the ``model`` axis is split
    by rows over ``model``, and so is its 1-D bias; everything else is
    replicated."""
    mp = axis_size(mesh, "model")
    shape = tuple(arr.shape)
    if mp > 1 and shape and shape[0] >= tp_threshold and shape[0] % mp == 0:
        if len(shape) == 2:
            return ("model", None)
        if len(shape) == 1:
            return ("model",)
    return REPLICATED


def tree_shardings(mesh, tree, tp_threshold: int = 1024):
    """The spec tree of a two-level ``{unit: {param: leaf}}`` tree."""
    return {name: {k: param_sharding(mesh, a, tp_threshold)
                   for k, a in leaves.items()}
            for name, leaves in tree.items()}


def local_shard(mesh, arr, spec: Spec):
    """This rank's part of the full leaf ``arr`` (a tensor or a numpy
    array): its rows over ``model`` where ``spec`` splits them, else
    ``arr`` itself."""
    if not spec or spec[0] != "model":
        return arr
    mp, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    rows = int(arr.shape[0]) // mp
    part = arr[r * rows:(r + 1) * rows]
    return (part.clone() if isinstance(part, torch.Tensor)
            else np.array(part))


def place_tree(mesh, tree, specs=None, tp_threshold: int = 1024):
    """A full host or device ``{unit: {param: leaf}}`` tree as this
    rank's local shards, per ``specs`` (default :func:`tree_shardings`)."""
    if specs is None:
        specs = tree_shardings(mesh, tree, tp_threshold)
    return {name: {k: local_shard(mesh, a, specs[name].get(k, REPLICATED))
                   for k, a in leaves.items()}
            for name, leaves in tree.items()}


class Placement(NamedTuple):
    """A module's column-sharded leaves: the mesh and ``{param: spec}``."""

    mesh: object
    specs: Dict[str, Spec]

    def local(self, key: str, value):
        """This rank's part of the full leaf ``value`` of ``key``."""
        return local_shard(self.mesh, value, self.specs.get(key, REPLICATED))

    def full(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of this rank's part ``t``: gathered over
        ``model`` (a collective every rank of the line joins) where
        ``key`` is split, else ``t``."""
        if not self.specs.get(key):
            return t
        return gather_rows(t, axis_group(self.mesh, "model"))

    def dtensor(self, key: str, t: torch.Tensor):
        """This rank's part ``t`` of ``key`` as a ``DTensor`` of the
        whole leaf on the mesh (rows sharded over ``model``, replicated
        over every other axis); ``t`` itself where ``key`` is not
        split."""
        if not self.specs.get(key):
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        placements = [Shard(0) if name == "model" else Replicate()
                      for name in self.mesh.mesh_dim_names]
        mp = axis_size(self.mesh, "model")
        shape = (mp * t.shape[0],) + tuple(t.shape[1:])
        return DTensor.from_local(t, self.mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())


def placement_of(module) -> Optional[Placement]:
    """The :class:`Placement` a meshed trainer gave ``module``, or None."""
    return getattr(module, "mesh_placement", None)


# -- the per-rank rows ---------------------------------------------------------


def local_rows(batch: int, dp: int, d: int) -> Tuple[int, int]:
    """(the first global row, rows a rank) of data coordinate ``d`` for a
    batch of ``batch`` rows: ``ceil(batch / dp)`` a rank; the last ranks'
    rows past the batch are padding."""
    n = -(-int(batch) // int(dp))
    return int(d) * n, n


def shard_index_rows(mat: np.ndarray, dp: int, d: int) -> np.ndarray:
    """The columns of the (k, B) index matrix ``mat`` that rank ``d``
    takes, (k, ceil(B / dp)); a column past B repeats the last index (a
    padded row, which the step counts invalid).  A rank gathers, stages
    and decodes only these rows (the counterpart of the reference's
    ``put_sharded_segment``)."""
    mat = np.asarray(mat)
    batch = mat.shape[1]
    row0, n = local_rows(batch, dp, d)
    return mat[:, np.minimum(np.arange(row0, row0 + n), batch - 1)]


# -- collectives ---------------------------------------------------------------


def _collective(fn: Callable, t: torch.Tensor, group):
    """Run the collective ``fn()`` on ``t``, counted in :data:`STATS`;
    ``fn``'s result."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (no-op for None)."""
    if group is not None:
        _collective(lambda: dist.all_reduce(t, group=group), t, group)
    return t


def sum_over(tensors: Sequence[torch.Tensor], group) -> list:
    """Each tensor summed over ``group`` in one collective: packed as
    float64 (exact for counts, and for two float32 addends the float32
    sum), summed, unpacked to each dtype and shape."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    all_reduce_(flat, group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def sum_gradients(grads: Sequence[torch.Tensor], group) -> list:
    """The gradients summed over ``group`` as one float32 buffer;
    float32 gradients back, in the given shapes."""
    if group is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` stacked along dim 0 in rank order over
    ``group``."""
    if group is None:
        return t
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _collective(lambda: dist.all_gather_into_tensor(out, t, group=group),
                out, group)
    return out


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient summed over ``model`` backward
    (each rank's columns give their part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """(n, c) columns of each rank gathered to (n, mp·c) in rank order
    forward; the rank's own columns of the gradient backward."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.cols = index, y.shape[1]
        stacked = gather_rows(y, group)              # (mp·n, c)
        mp = stacked.shape[0] // y.shape[0]
        return stacked.reshape(mp, y.shape[0], y.shape[1]).permute(
            1, 0, 2).reshape(y.shape[0], mp * y.shape[1])

    @staticmethod
    def backward(ctx, g):
        c0 = ctx.index * ctx.cols
        return g[:, c0:c0 + ctx.cols].contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """A column-sharded layer's input: itself forward, its gradient
    summed over ``model`` backward."""
    group = axis_group(mesh, "model")
    return x if group is None else _CopyToModel.apply(x, group)


def gather_columns(y: torch.Tensor, mesh) -> torch.Tensor:
    """A column-sharded layer's (n, F / mp) output as the (n, F) whole;
    backward, the rank's own columns of the gradient."""
    group = axis_group(mesh, "model")
    if group is None:
        return y
    return _GatherColumns.apply(y.reshape(y.shape[0], -1), group,
                                axis_index(mesh, "model"))


# -- the sequence axis ---------------------------------------------------------


def _ring_p2p(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """``t`` sent ``step`` ranks on along ``group`` (1: to the next),
    the tensor of the rank ``step`` behind received in its place; counted
    in :data:`STATS`.  Both operations are posted in one
    ``batch_isend_irecv``, so two ranks, each the other's next and
    previous, do not wait on each other.  gloo sends no CUDA tensor, so
    on the card a block is staged through host memory (the stream
    synchronised first, as :func:`_collective` does)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    t = t.detach().contiguous()
    staged = t.is_cuda and dist.get_backend(group) == "gloo"

    def shift():
        send = t.cpu() if staged else t
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]):
            req.wait()
        return recv.to(t.device) if staged else recv

    return _collective(shift, t, group)


class _RingShift(torch.autograd.Function):
    """Each rank's tensor to the next rank of ``group`` forward; the
    gradient to the previous one backward, the transpose JAX takes of
    ``ppermute``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _ring_p2p(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_p2p(g, ctx.group, -1), None


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's ``t`` on each rank of ``group`` (the ring
    hop of the reference's ``ppermute`` with ``perm = [(j, j + 1)]``);
    gradients travel back the other way."""
    return _RingShift.apply(t, group)


def _gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (b, T/n, ...) blocks of ``group`` joined along dim 1
    in rank order: (b, T, ...)."""
    stacked = gather_rows(t.contiguous(), group)    # (n·b, T/n, ...)
    n = stacked.shape[0] // t.shape[0]
    return stacked.reshape((n,) + tuple(t.shape)).transpose(0, 1).reshape(
        (t.shape[0], n * t.shape[1]) + tuple(t.shape[2:]))


def _own_block(t: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[1] // n
    return t[:, r * size:(r + 1) * size]


class _SeqBlock(torch.autograd.Function):
    """This rank's block along dim 1 of a tensor every rank of ``group``
    holds whole forward; the blocks' gradients gathered backward, so the
    whole tensor's gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _own_block(t, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


class _SeqGather(torch.autograd.Function):
    """The ranks' blocks joined along dim 1 forward; this rank's own
    block of the gradient backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gather_seq(t, group)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.group).contiguous(), None


def seq_block(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the (b, T, ...) tensor ``t`` along T, rank
    ``r`` of ``group`` taking positions ``[r·T/n, (r+1)·T/n)``; ``t``
    itself without a group."""
    return t if group is None else _SeqBlock.apply(t, group)


def seq_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The (b, T/n, ...) blocks of ``group``'s ranks as one (b, T, ...)
    tensor on every rank; ``t`` itself without a group."""
    return t if group is None else _SeqGather.apply(t, group)


def raise_anywhere(error: Optional[BaseException], what: str) -> None:
    """Raise on every rank of the world when ``error`` is set on any
    (itself without a group): a collective, so that no rank goes on
    after another's step failed."""
    if world_size() == 1:
        if error is not None:
            raise error
        return
    errors = [None] * world_size()
    dist.all_gather_object(errors, None if error is None else repr(error))
    failed = {r: e for r, e in enumerate(errors) if e is not None}
    if failed:
        raise RuntimeError(f"{what} failed on rank(s) {sorted(failed)}: "
                           f"{failed}") from error


def agree(value):
    """Rank 0's ``value`` on every rank of the world (a picklable object;
    itself without a group)."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]
