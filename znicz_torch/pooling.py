"""Pooling over NHWC (port of ``MaxPooling``, ``MaxAbsPooling``,
``AvgPooling``, ``StochasticPooling`` and ``StochasticAbsPooling`` in
``znicz_tpu/pooling.py``).

The reference's geometry: ``sliding`` defaults to the kernel size,
partial windows at the right/bottom edges are kept, and the plane is
padded up to ``(oh-1)*sy + ky`` rows and ``(ow-1)*sx + kx`` columns,
exactly as its ``reduce_window`` pads: with -inf for a maximum, +inf for
a minimum and 0 for a sum.  ``AvgPooling`` divides each window's sum by
its count of real elements, not by ky*kx.  Gradients are autograd's of
the same formulation; a maximum's goes to the first of tied elements in
window order, as XLA's ``select_and_scatter`` sends it, unless
``root.common.engine.pool_bwd`` is "mask", which splits it equally among
them, as the reference's opt-in masked backward does.

The unit engine's max pooling (:class:`MaxPoolingUnit`) takes the
reference's unit path instead: it gathers every window
(:meth:`PoolingBase.windows`), picks the first element of largest value
(``MaxPooling``) or largest magnitude (``MaxAbsPooling``, whose pad is 0
there, so a tie of ``x`` and ``-x`` goes to the first, not to the
positive), and records that offset for its GD unit's scatter
(:meth:`PoolingBase.scatter_at_offsets`), which a Depooling's forward
reuses; its exact adjoint, :meth:`PoolingBase.gather_at_offsets`, is the
Depooling's backward.

Stochastic pooling (pad 0) weighs each window's elements by ``max(x, 0)``
(``StochasticPooling``) or ``|x|`` (``StochasticAbsPooling``).  In
training it outputs the element at a position sampled with probability
proportional to its weight (an all-zero window picks position 0); in
evaluation, and as the module's own forward, the probability-weighted
mean ``sum(win * (p / total))``, with the offsets of the heaviest
element.  The draw is the reference's Gumbel-max over ``log(p)``
(:meth:`StochasticPoolingBase.sample_offsets`), from a
``torch.Generator`` (Philox on a GPU) where the reference draws from
threefry keys, so the offsets differ unless a test injects the
reference's through the ``offset_fn`` seam of
:class:`StochasticPoolingUnit` or of ``FusedTrainer``.  The gradient of a
sampled output is :class:`_StochasticSelect`'s: ``scatter_at_offsets``,
masked strided adds, with no atomics where windows overlap.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from znicz_torch.core import prng
from znicz_torch.core.config import root
from znicz_torch.forward import ForwardModule
from znicz_torch.loader.base import TRAIN
from znicz_torch.memory import Array
from znicz_torch.nn_units import ForwardBase


def pool_output_hw(h: int, w: int, ky: int, kx: int,
                   sliding: Tuple[int, int]) -> Tuple[int, int]:
    sy, sx = sliding
    return (max(1, -(-max(h - ky, 0) // sy) + 1),
            max(1, -(-max(w - kx, 0) // sx) + 1))


class PoolingBase(ForwardModule):
    def __init__(self, name=None, kx=2, ky=2, sliding=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.kx = int(kx)
        self.ky = int(ky)
        self.sliding = (tuple(int(s) for s in sliding) if sliding
                        else (self.ky, self.kx))

    def output_shape_for(self, in_shape):
        b, h, w, c = in_shape
        oh, ow = pool_output_hw(h, w, self.ky, self.kx, self.sliding)
        return (b, oh, ow, c)

    def _padded_hw(self, h: int, w: int) -> Tuple[int, int]:
        oh, ow = pool_output_hw(h, w, self.ky, self.kx, self.sliding)
        sy, sx = self.sliding
        return (oh - 1) * sy + self.ky, (ow - 1) * sx + self.kx

    def exact_tiling(self) -> bool:
        """True when every window is full: the padded extent equals the
        built input plane.  The fused block kernel's precondition."""
        _, h, w, _ = self.in_shape
        return self._padded_hw(h, w) == (h, w)

    def _padded(self, x, value: float):
        """The NCHW view of the NHWC ``x``, padded with ``value`` at the
        right and bottom up to the extent the windows cover."""
        _, h, w, _ = x.shape
        ph, pw = self._padded_hw(h, w)
        xn = x.permute(0, 3, 1, 2)
        if (ph, pw) != (h, w):
            xn = F.pad(xn, (0, pw - w, 0, ph - h), value=value)
        return xn

    def _max(self, x):
        """Each window's maximum, NCHW."""
        return F.max_pool2d(self._padded(x, float("-inf")),
                            (self.ky, self.kx), stride=self.sliding)

    @staticmethod
    def _nhwc(y):
        return y.permute(0, 2, 3, 1).contiguous()

    def windows(self, x, value: float):
        """(B, OH, OW, C, ky*kx) view of every window of the NHWC ``x``,
        padded with ``value``; the last axis runs over (ky, kx) in row
        order, the offset convention of the reference's unit path."""
        _, h, w, _ = x.shape
        ph, pw = self._padded_hw(h, w)
        if (ph, pw) != (h, w):
            x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h), value=value)
        sy, sx = self.sliding
        win = x.unfold(1, self.ky, sy).unfold(2, self.kx, sx)
        return win.reshape(tuple(win.shape[:4]) + (self.ky * self.kx,))

    def scatter_at_offsets(self, values, offsets, in_shape):
        """An ``in_shape`` tensor with each of ``values`` (output-shaped)
        added at its window's recorded offset.  One masked strided add
        per window position, in (ky, kx) order: no atomics, the same sum
        order on every device."""
        b, h, w, c = in_shape
        ph, pw = self._padded_hw(h, w)
        oh, ow = values.shape[1], values.shape[2]
        sy, sx = self.sliding
        out = values.new_zeros((b, ph, pw, c))
        for i in range(self.ky):
            for j in range(self.kx):
                part = torch.where(offsets == i * self.kx + j, values, 0.0)
                out[:, i:i + (oh - 1) * sy + 1:sy,
                    j:j + (ow - 1) * sx + 1:sx] += part
        return out[:, :h, :w].contiguous()

    def gather_at_offsets(self, full, offsets):
        """An output-shaped tensor of the input-shaped ``full``'s elements
        at the recorded offsets: the exact adjoint of
        :meth:`scatter_at_offsets` (Depooling's backward).  Each element
        is selected, never summed, so its bits are kept."""
        _, h, w, _ = full.shape
        ph, pw = self._padded_hw(h, w)
        if (ph, pw) != (h, w):
            full = F.pad(full, (0, 0, 0, pw - w, 0, ph - h))
        oh, ow = offsets.shape[1], offsets.shape[2]
        sy, sx = self.sliding
        out = full.new_zeros(tuple(offsets.shape))
        for i in range(self.ky):
            for j in range(self.kx):
                at = full[:, i:i + (oh - 1) * sy + 1:sy,
                          j:j + (ow - 1) * sx + 1:sx]
                out = torch.where(offsets == i * self.kx + j, at, out)
        return out

    def _pick(self, win, key):
        """(output, offsets): the first window element of largest
        ``key(win)``."""
        off = torch.argmax(key(win), dim=-1)
        return torch.gather(win, -1, off.unsqueeze(-1)).squeeze(-1), off


class _MaskedMaxPool(torch.autograd.Function):
    """A max pool whose backward splits each window's gradient equally
    among its tied maxima, op by op as the reference's ``_masked_maxpool``
    (``znicz_tpu/pooling.py``): the tie masks ``x == y`` of the padded
    window positions in (ky, kx) order, their count ``nt`` summed in that
    order, ``g / nt``, and each position's share added back into a zero
    plane of the padded input in the same order."""

    @staticmethod
    def forward(ctx, x, pool):
        y = pool._nhwc(pool._max(x))
        ctx.save_for_backward(x, y)
        ctx.pool = pool
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        pool = ctx.pool
        b, h, w, c = x.shape
        oh, ow = y.shape[1], y.shape[2]
        ph, pw = pool._padded_hw(h, w)
        sy, sx = pool.sliding
        xp = F.pad(x, (0, 0, 0, pw - w, 0, ph - h), value=float("-inf"))
        at = [(slice(None), slice(i, i + (oh - 1) * sy + 1, sy),
               slice(j, j + (ow - 1) * sx + 1, sx))
              for i in range(pool.ky) for j in range(pool.kx)]
        masks = [(xp[ix] == y).to(g.dtype) for ix in at]
        nt = masks[0]
        for m in masks[1:]:
            nt = nt + m
        inv = g / nt
        dxp = None
        for ix, m in zip(at, masks):
            part = g.new_zeros((b, ph, pw, c))
            part[ix] = inv * m
            dxp = part if dxp is None else dxp + part
        return dxp[:, :h, :w].to(x.dtype), None


class MaxPooling(PoolingBase):
    """Under ``root.common.engine.pool_bwd = "mask"`` its gradient splits
    among tied maxima (:class:`_MaskedMaxPool`), as the reference's does;
    the unit engine's GD unit scatters to the recorded offsets either
    way, as the reference's ``GDMaxPooling`` does."""

    def forward(self, x):
        if str(root.common.engine.get("pool_bwd", "sas")) == "mask":
            return _MaskedMaxPool.apply(x, self)
        return self._nhwc(self._max(x))

    def select(self, x):
        """The unit path's (output, offsets)."""
        return self._pick(self.windows(x, float("-inf")), lambda w: w)


class MaxAbsPooling(PoolingBase):
    """The signed value of larger magnitude in each window: ``min`` where
    ``-min > max``, else ``max`` (on an exact tie the maximum wins)."""

    def forward(self, x):
        mx = self._max(x)
        mn = -self._max(-x)
        return self._nhwc(torch.where(-mn > mx, mn, mx))

    def select(self, x):
        """The unit path's (output, offsets): pad 0, first of largest
        magnitude."""
        return self._pick(self.windows(x, 0.0), torch.abs)


class AvgPooling(PoolingBase):
    def __init__(self, name=None, **kwargs):
        super().__init__(name=name, **kwargs)
        self._counts = None          # window_counts() on the last device

    def window_counts(self) -> np.ndarray:
        """(OH, OW) count of real (non-pad) elements in each window of the
        built input plane."""
        _, h, w, _ = self.in_shape
        oh, ow = pool_output_hw(h, w, self.ky, self.kx, self.sliding)
        sy, sx = self.sliding
        rows = np.minimum(np.arange(oh) * sy + self.ky, h) - np.arange(oh) * sy
        cols = np.minimum(np.arange(ow) * sx + self.kx, w) - np.arange(ow) * sx
        return np.outer(rows, cols).astype(np.float32)

    def _counts_on(self, device) -> torch.Tensor:
        if self._counts is None or self._counts.device != device:
            self._counts = torch.from_numpy(self.window_counts()).to(device)
        return self._counts

    def forward(self, x):
        s = F.avg_pool2d(self._padded(x, 0.0), (self.ky, self.kx),
                         stride=self.sliding, divisor_override=1)
        return self._nhwc(s / self._counts_on(x.device))


class MaxPoolingUnit(ForwardBase):
    """The unit of a ``MaxPooling`` or ``MaxAbsPooling`` module: its
    output is the module's ``select``, whose offsets it records in
    ``input_offset`` for the GD unit."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        super().__init__(workflow=workflow, name=name, module=module,
                         **kwargs)
        self.input_offset = Array()

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        self.input_offset.initialize(device)

    def run(self):
        with torch.no_grad():
            y, off = self.module.select(self.input.devmem)
        self.output.devmem = y
        self.input_offset.devmem = off


class _StochasticSelect(torch.autograd.Function):
    """The element of each window at ``offsets``, whose backward is
    :meth:`PoolingBase.scatter_at_offsets`: the gradient of the sampled
    output goes to its input position, summed in window order where
    windows overlap, the same bits on every run."""

    @staticmethod
    def forward(ctx, x, offsets, pool):
        ctx.save_for_backward(offsets)
        ctx.pool, ctx.in_shape = pool, tuple(x.shape)
        win = pool.windows(x, pool.PAD_VALUE)
        return torch.gather(win, -1, offsets.unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        offsets, = ctx.saved_tensors
        return (ctx.pool.scatter_at_offsets(g, offsets, ctx.in_shape),
                None, None)


class StochasticPoolingBase(PoolingBase):
    PAD_VALUE = 0.0

    def weights_from(self, win):
        """The sampling weight of each window element."""
        raise NotImplementedError

    def probabilities(self, win):
        """Each window's weights over their sum, as the reference divides
        them (``p / max(total, 1e-30)``); an all-zero window is one-hot
        at position 0."""
        p = self.weights_from(win)
        total = torch.sum(p, dim=-1, keepdim=True)
        first = torch.zeros_like(p)
        first[..., 0] = 1.0
        return torch.where(total > 0, p / torch.clamp_min(total, 1e-30),
                           first)

    @staticmethod
    def sample_offsets(probs, generator: torch.Generator):
        """One position per window drawn with ``probs`` (the last axis):
        the reference's ``jax.random.categorical`` formulation, the
        first argmax of ``log(max(probs, 1e-30))`` plus Gumbel noise,
        the noise from ``generator`` on its device."""
        u = torch.rand(tuple(probs.shape), generator=generator,
                       device=generator.device, dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, tiny, 1.0)))
        logits = torch.log(torch.clamp_min(probs.float(), 1e-30))
        return torch.argmax(logits + gumbel, dim=-1)

    def select_sampled(self, x, offsets):
        """The output of training: the element at ``offsets`` of each
        window, its gradient scattered back to it."""
        return _StochasticSelect.apply(x, offsets, self)

    def select_expected(self, x):
        """(output, offsets) of evaluation: the probability-weighted mean,
        and the offsets of each window's first heaviest element."""
        win = self.windows(x, self.PAD_VALUE)
        p = self.weights_from(win)
        total = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
        return (torch.sum(win * (p / total), dim=-1),
                torch.argmax(p, dim=-1))

    def forward(self, x):
        return self.select_expected(x)[0]


class StochasticPooling(StochasticPoolingBase):
    """Positions sampled in proportion to ``max(x, 0)``."""

    def weights_from(self, win):
        return torch.clamp_min(win, 0.0)


class StochasticAbsPooling(StochasticPoolingBase):
    """Positions sampled in proportion to ``|x|``."""

    def weights_from(self, win):
        return torch.abs(win)


class StochasticPoolingUnit(MaxPoolingUnit):
    """The unit of a stochastic pooling module.  On a TRAIN minibatch
    (``minibatch_class`` is linked from the loader) its output is the
    sampled select, the offsets from ``offset_fn(step, probs)``, ``step``
    counting the unit's TRAIN minibatches; by default they are drawn from
    the unit's own ``core.prng`` stream as a ``torch.Generator``
    (:meth:`default_offsets`).  On the others, the expectation.  Either
    way it records the offsets for its GD unit."""

    def __init__(self, workflow=None, name=None, module=None, **kwargs):
        super().__init__(workflow=workflow, name=name, module=module,
                         **kwargs)
        self.minibatch_class = TRAIN
        self.offset_fn: Optional[Callable] = None
        self._step_counter = 0

    def default_offsets(self, step: int, probs):
        gen = prng.get(self.name).torch_generator(step, 0, probs.device)
        return StochasticPoolingBase.sample_offsets(probs, gen)

    def run(self):
        x, mod = self.input.devmem, self.module
        with torch.no_grad():
            if int(self.minibatch_class) == TRAIN:
                probs = mod.probabilities(mod.windows(x, mod.PAD_VALUE))
                off = (self.offset_fn or self.default_offsets)(
                    self._step_counter, probs).to(x.device)
                self._step_counter += 1
                y = mod.select_sampled(x, off)
            else:
                y, off = mod.select_expected(x)
        self.output.devmem = y
        self.input_offset.devmem = off
