"""CUDA-graph capture of one train or eval step (the port's counterpart of
the reference's ``make_train_scan`` / ``make_eval_scan``: a segment of k
steps is k replays of one captured step), and of one served forward a
ladder rung (``serving/model.py``: the counterpart of the reference's
bucketed jit cache; a generation's rungs share one memory pool).

A :class:`StepGraph` owns the static buffers a step reads (its index row
or staged rows, its hyperparameter row, its dropout masks), the captured
graph, and the step's outputs, which every replay overwrites in place.
Before a replay the trainer copies the step's inputs into the buffers on
the device; nothing in a replay waits on the host.

Launch counts.  Each kernel wrapper counts its launches in
``<wrapper>.launches`` when Python calls it, and a replay calls no
Python.  :meth:`StepGraph.capture` therefore reads the counters around
the capture, takes back what the capture added (a capture runs nothing),
and :meth:`StepGraph.replay` adds those counts once a replay, so the
counters stay the number of kernels the card ran.

A capture runs on :func:`capture_stream`, one side stream a device, in
the ``thread_local`` error mode: a call that is illegal under capture (a
synchronisation, a pageable copy) made by the capturing thread raises
there, and the trainer lets it raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def counted() -> Tuple:
    """Every kernel wrapper that counts its launches: K1, K1b, K2, K2b,
    K3, K3b and their bf16 variants."""
    from znicz_torch import fused_block as fb
    from znicz_torch.ops import lrn

    return (fb.fused_block_fwd, fb.fused_block_bwd, fb.bias_relu_fwd,
            fb.bias_relu_bwd, lrn.lrn_fwd, lrn.lrn_bwd,
            fb.fused_block_bf16_fwd, fb.fused_block_bf16_bwd,
            fb.bias_relu_bf16_fwd, fb.bias_relu_bf16_bwd, lrn.lrn_bf16_fwd,
            lrn.lrn_bf16_bwd)


def _read() -> List[Tuple[int, int]]:
    return [(w.launches, getattr(w, "simple_launches", 0))
            for w in counted()]


def _add(counts: List[Tuple[int, int]], sign: int = 1) -> None:
    for w, (n, simple) in zip(counted(), counts):
        w.launches += sign * n
        if simple:
            w.simple_launches += sign * simple


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream on which the trainer warms up and captures its
    steps on ``device``."""
    index = torch.device(device).index or 0
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


class StepGraph:
    """One captured step.  ``inputs`` are the static input buffers by
    name, ``hyp`` the static (M, 8) hyperparameter row (None for an eval
    step), ``masks`` the static dropout masks by forwards index with the
    (shape, ratio) each is drawn with."""

    def __init__(self, inputs: Dict[str, torch.Tensor],
                 hyp: Optional[torch.Tensor],
                 masks: Dict[int, Tuple[torch.Tensor, tuple, float]]):
        self.inputs = inputs
        self.hyp = hyp
        self.masks = masks
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.outputs = None
        #: launches of one replay, per counted wrapper
        self.launches: List[Tuple[int, int]] = []
        #: tensors the graph's kernels address outside its own pool (the
        #: bias+ReLU backward's workspace on the capture stream)
        self.keep: list = []

    def mask(self, step: int, index: int, shape, ratio: float):
        """The mask seam inside the capture: the static buffer of
        ``index``, filled before each replay."""
        buf, want, _ = self.masks[index]
        if tuple(shape) != want:
            raise ValueError(f"mask {index}: captured {want}, asked for "
                             f"{tuple(shape)}")
        return buf

    def capture(self, body: Callable, stream: "torch.cuda.Stream",
                pool=None) -> None:
        """Capture ``body()`` (which reads the static buffers) on
        ``stream``, its memory from ``pool`` (a
        ``torch.cuda.graph_pool_handle()`` shared with other captures;
        None: a private pool of its own); its return value becomes
        :attr:`outputs`."""
        from znicz_torch import fused_block

        before = _read()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = body()
        after = _read()
        self.launches = [(a - b, sa - sb) for (a, sa), (b, sb)
                         in zip(after, before)]
        _add(self.launches, -1)
        self.graph = graph
        sid = stream.cuda_stream
        self.keep = [ws for (dev, s), ws in
                     fused_block._BR_WORKSPACE.items() if s == sid]

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches)

    def release(self) -> None:
        """Free the graph and drop its buffers (its pool's blocks go back
        to the caching allocator once no graph holds the pool)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.outputs = None
        self.inputs = {}
        self.keep = []
