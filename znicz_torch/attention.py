"""Sequence-model modules (port of ``znicz_tpu/attention.py``): the
attention layer, the token embedding and the position-wise dense layers,
each with its GD twin.  Inputs and outputs are (batch, seq, width).

  - :class:`MultiHeadAttention` — ``heads`` heads of ``head_dim`` (default
    ``embed // heads``), optionally ``causal`` and ``residual`` (``y = x
    + attn(x)``); parameters ``wq``, ``wk``, ``wv`` (embed, heads *
    head_dim) and ``wo`` (heads * head_dim, embed), no bias.  Besides
    the forward, the serving forms :meth:`~MultiHeadAttention.apply_prefill`,
    :meth:`~MultiHeadAttention.apply_prefill_chunk` and
    :meth:`~MultiHeadAttention.apply_decode`.  The sequence-parallel
    (ring) core runs in three ways, as the reference's does: ``sp_axis``
    names a process group whose ranks hold consecutive sequence blocks
    (the caller passes this rank's block: the counterpart of a call
    already inside a ``shard_map``);
    :meth:`~MultiHeadAttention.bind_sequence_mesh` rings over a meshed
    trainer's ``model`` axis; and ``root.common.engine.seq_parallel = N
    > 1``, where nothing is bound by the first forward, rings over an
    ``("sp",)`` mesh of the whole initialised world, which must be N
    ranks (:func:`seq_parallel_size`).  The last two take this rank's
    block of the whole q/k/v, ring, and gather the output again: each
    rank of the ring must hold the same whole input;
  - :class:`CharEmbedding` — (batch, seq) token ids to token plus
    position embeddings, tables ``embed`` (vocab, embed) and ``pos``
    (max_len, embed).  Ids arrive as uint8 or as the floats of the u8
    decode: they are truncated to integers and clipped to ``[0, vocab -
    1]`` before the lookup (torch's indexing raises where ``jnp.take``
    clamps).  Positions index from 0, so a request padded on the right
    keeps its real tokens' positions;
  - :class:`SeqAll2All` and its ``Tanh``, ``StrictRELU`` and ``Softmax``
    kinds — ``act(x @ W^T + b)`` at every position, All2All's ``(out,
    in)`` weight layout (``(in, out)`` with ``weights_transposed``).

Each module draws its parameters as the reference's unit does, from its
named ``core.prng`` stream in the reference's order, so a charlm tree and
its snapshots carry over by name (``weights.params_from_jax``).

The GD twins are the vjp of the forward (``nn_units.GradientDescentBase``);
``GDSeqSoftmax`` takes the vjp of the product only, as ``GDSoftmax``
does, because the evaluator's cotangent is already the logits'.
``GDCharEmbedding`` gives no ``err_input``: its input is integral.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from znicz_torch.forward import ForwardModule
from znicz_torch.nn_units import GradientDescentBase
from znicz_torch.ops import activations
from znicz_torch.ops.attention import (attention, cache_append,
                                       decode_attention, ring_attention)
from znicz_torch.ops.linear import seq_linear
from znicz_torch.parallel import mesh as mesh_mod


def _parameter(array: np.ndarray, device) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(array).to(device),
                        requires_grad=False)


def seq_parallel_size() -> int:
    """The ``root.common.engine.seq_parallel`` knob: the ranks of the
    ``("sp",)`` mesh a MultiHeadAttention rings over (0 or 1: off, the
    dense core)."""
    from znicz_torch.core.config import root

    return int(root.common.engine.get("seq_parallel", 0))


def _ring_mesh(name: str, sp: int):
    """The ``("sp",)`` mesh of the whole initialised world, which must be
    ``sp`` ranks: the reference's ranks are virtual devices of one
    process, the port's are processes, each holding the whole input."""
    world = mesh_mod.world_size()
    if world != sp:
        raise RuntimeError(
            f"{name}: root.common.engine.seq_parallel={sp} rings the "
            f"sequence over {sp} ranks, one a process, but this process's "
            f"world has {world}: start {sp} processes (torchrun "
            f"--nproc-per-node {sp} ...) and join each with "
            f"znicz_torch.parallel.mesh.distributed_init before the "
            f"first forward, or bind a trainer's mesh "
            f"(bind_sequence_mesh)")
    return mesh_mod.make_mesh((sp,), ("sp",))


class MultiHeadAttention(ForwardModule):
    has_weights = True
    PARAM_NAMES = ("wq", "wk", "wv", "wo")

    def __init__(self, name=None, heads=4, head_dim=None, causal=False,
                 sp_axis=None, residual=False, **kwargs):
        super().__init__(name=name, **kwargs)
        self.heads = int(heads)
        self.head_dim = None if head_dim is None else int(head_dim)
        self.causal = bool(causal)
        self.residual = bool(residual)
        #: a process group whose ranks hold consecutive sequence blocks:
        #: the forward's input is this rank's block, and the core rings
        self.sp_axis = sp_axis
        #: the mesh the core rings over when the input is whole: a
        #: trainer's mesh (:meth:`bind_sequence_mesh`), or the private
        #: ("sp",) mesh of the knob, taken at the first forward
        self._sp_mesh = None
        #: that mesh's sequence axis
        self._seq_axis = "sp"
        #: the knob's ring size as ``build`` read it (0: none)
        self._sp_size = 0
        self.wq = self.wk = self.wv = self.wo = None

    def bind_sequence_mesh(self, mesh, batch_axis="data",
                           seq_axis="model") -> bool:
        """Ring over ``mesh``'s ``seq_axis`` (a meshed trainer's) instead
        of a private ("sp",) mesh; sticky.  False, and nothing bound, for
        None or a mesh without a ``seq_axis`` of at least 2 ranks.  The
        trainer gives each rank its rows of ``batch_axis`` before the
        module sees them, so only the sequence is split here and
        ``batch_axis`` is not kept."""
        if mesh_mod.axis_size(mesh, seq_axis) < 2:
            return False
        self._sp_mesh = mesh
        self._seq_axis = seq_axis
        return True

    def output_shape_for(self, in_shape):
        return tuple(in_shape)

    def build(self, in_shape, device):
        """The four projections for a (batch, seq, embed) input, each
        uniform over ±stddev·√3 with stddev 1/√(its first axis) unless
        ``weights_stddev`` is given, drawn wq, wk, wv, wo.  With
        ``seq_parallel`` N > 1 (and neither ``sp_axis`` nor a bound mesh)
        a sequence length N does not divide raises ``ValueError``; the
        ring of N ranks is taken at the first forward unless a mesh is
        bound by then (:func:`_ring_mesh`)."""
        self.in_shape = tuple(int(d) for d in in_shape)
        e = self.in_shape[-1]
        if self.head_dim is None:
            if e % self.heads:
                raise ValueError(f"{self.name}: embed {e} not divisible by "
                                 f"heads {self.heads}")
            self.head_dim = e // self.heads
        sp = seq_parallel_size()
        if sp > 1 and self.sp_axis is None and self._sp_mesh is None:
            t = self.in_shape[1]
            if t % sp:
                raise ValueError(
                    f"{self.name}: root.common.engine.seq_parallel={sp} "
                    f"cannot split sequence length {t}; pick a seq length "
                    f"divisible by the sp mesh size")
            self._sp_size = sp
        hd = self.heads * self.head_dim
        for key, shape in (("wq", (e, hd)), ("wk", (e, hd)),
                           ("wv", (e, hd)), ("wo", (hd, e))):
            w = self._fill(shape, self.weights_filling,
                           self.weights_stddev or 1.0 / np.sqrt(shape[0]))
            setattr(self, key, _parameter(w, device))
        return self.output_shape_for(self.in_shape)

    def _project(self, x):
        """(q, k, v) of the (batch, t, embed) hiddens ``x``, each (batch,
        t, heads, head_dim)."""
        b, t = x.shape[:2]
        h, d = self.heads, self.head_dim
        return tuple((x @ w).reshape(b, t, h, d)
                     for w in (self.wq, self.wk, self.wv))

    def _out(self, x, o):
        y = o.reshape(o.shape[0], o.shape[1], -1) @ self.wo
        return x + y if self.residual else y

    def _core(self, q, k, v):
        """The attention of the projections: the ring over ``sp_axis``
        on this rank's block; over the bound mesh's sequence group when
        it divides the length (this rank's block of the whole q/k/v,
        the output blocks gathered); else the dense core, as the
        reference takes it for a short serving bucket."""
        if self.sp_axis is not None:
            return ring_attention(q, k, v, self.sp_axis, causal=self.causal)
        if self._sp_mesh is None and self._sp_size > 1:
            self._sp_mesh = _ring_mesh(self.name, self._sp_size)
        group = mesh_mod.axis_group(self._sp_mesh, self._seq_axis)
        if group is None \
                or q.shape[1] % torch.distributed.get_world_size(group):
            return attention(q, k, v, causal=self.causal)
        qb, kb, vb = mesh_mod.seq_block(torch.stack([q, k, v], 2),
                                        group).unbind(2)
        return mesh_mod.seq_gather(
            ring_attention(qb, kb, vb, group, causal=self.causal), group)

    def forward(self, x):
        q, k, v = self._project(x)
        return self._out(x, self._core(q, k, v))

    def apply_prefill(self, x):
        """The forward that also returns the keys and values it computed,
        to seed a decode cache from a prompt: ``(y, k, v)``, k and v
        (batch, seq, heads, head_dim)."""
        q, k, v = self._project(x)
        return self._out(x, attention(q, k, v, causal=self.causal)), k, v

    def apply_prefill_chunk(self, x, k_view, v_view, t0):
        """A chunked prefill step: ``x`` is a (batch, chunk, embed) chunk
        whose row ``i`` sits at global positions ``t0[i] ..
        t0[i] + chunk - 1``; ``k_view``/``v_view`` (batch, ctx, heads,
        head_dim) hold each row's prefix ``[0, t0)``.  The chunk's keys
        and values are written at their positions (those past the view
        are dropped), the chunk attends causally at its offsets, and
        ``(y, k_rows, v_rows)`` comes back for the caller to persist."""
        b, c = x.shape[:2]
        q, k_rows, v_rows = self._project(x)
        t0 = torch.as_tensor(t0, device=x.device).long()
        ctx = k_view.shape[1]
        # positions past the view land in one scratch column, cut after
        idx = torch.clamp(t0[:, None] + torch.arange(c, device=x.device),
                          max=ctx)
        rows = torch.arange(b, device=x.device)[:, None]

        def write(view, new):
            pad = torch.zeros_like(view[:, :1])
            return torch.cat([view, pad], 1).index_put(
                (rows, idx), new)[:, :ctx]

        o = attention(q, write(k_view, k_rows), write(v_view, v_rows),
                      causal=True, q_offset=t0)
        return self._out(x, o), k_rows, v_rows

    def apply_decode(self, x_t, k_cache, v_cache, t):
        """One decode step: ``x_t`` (batch, 1, embed) at per-row position
        ``t``; this step's key and value are appended at ``t`` and the
        query attends ``[0..t]``.  Returns ``(y_t, k_row, v_row)``, the new
        rows (batch, heads, head_dim) for the caller to persist."""
        q, k, v = self._project(x_t)
        k_row, v_row = k[:, 0], v[:, 0]
        o = decode_attention(q, cache_append(k_cache, k_row, t),
                             cache_append(v_cache, v_row, t), t)
        return self._out(x_t, o), k_row, v_row


class GDMultiHeadAttention(GradientDescentBase):
    """The vjp of the attention forward, the per-layer hyperparameters as
    usual."""


class _Lookup(torch.autograd.Function):
    """``table[idx]`` forward; backward, the rows' gradients summed into
    a zero table in ``idx`` order, as the reference's scatter-add sums
    them: ``index_add_`` on the CPU, ``index_put_(accumulate=True)`` (a
    stable sort, then one pass) on the card, where ``index_add_`` adds
    with atomics in an order that differs run to run, and two ranks
    holding one replicated table would part."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = tuple(table.shape)
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        if g.is_cuda:
            return grad.index_put_((idx,), g, accumulate=True), None
        return grad.index_add_(0, idx, g), None


class CharEmbedding(ForwardModule):
    has_weights = True
    PARAM_NAMES = ("embed", "pos")

    def __init__(self, name=None, vocab=256, embed=64, max_len=128,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.vocab = int(vocab)
        #: the embedding width (the reference's ``embed``; here the name
        #: of the token table)
        self.embed_dim = int(embed)
        self.max_len = int(max_len)
        self.embed = self.pos = None

    def output_shape_for(self, in_shape):
        return (in_shape[0], in_shape[1], self.embed_dim)

    def build(self, in_shape, device):
        """The token and position tables, drawn in that order with stddev
        1/√embed unless ``weights_stddev`` is given.  A sequence longer
        than ``max_len`` is refused."""
        self.in_shape = tuple(int(d) for d in in_shape)
        t = self.in_shape[1]
        if t > self.max_len:
            raise ValueError(
                f"{self.name}: input seq length {t} exceeds max_len="
                f"{self.max_len} (the positional table's size)")
        for key, shape in (("embed", (self.vocab, self.embed_dim)),
                           ("pos", (self.max_len, self.embed_dim))):
            w = self._fill(shape, self.weights_filling,
                           self.weights_stddev
                           or 1.0 / np.sqrt(self.embed_dim))
            setattr(self, key, _parameter(w, device))
        return self.output_shape_for(self.in_shape)

    def ids(self, x) -> torch.Tensor:
        """Token ids (uint8, or the floats of its decode) as int64,
        truncated and clipped to the table."""
        return torch.clamp(x.to(torch.int32), 0, self.vocab - 1).long()

    def _lookup(self, table, idx):
        """``table`` rows at ``idx`` (any shape); its gradient is a
        scatter-add, as ``jnp.take``'s is (:class:`_Lookup`)."""
        rows = _Lookup.apply(table, idx.reshape(-1))
        return rows.reshape(tuple(idx.shape) + (table.shape[1],))

    def forward(self, x):
        t = x.shape[1]
        return self._lookup(self.embed, self.ids(x)) + self.pos[:t][None]

    def apply_offset(self, x, t0):
        """A chunk's embedding at per-row offsets: ``x`` (batch, chunk)
        ids whose row ``i`` sits at positions ``t0[i] ..``; positions
        clip at the table's top, as :meth:`apply_decode`'s do."""
        t0 = torch.as_tensor(t0, device=x.device).long()
        pos = torch.clamp(t0[:, None] + torch.arange(x.shape[1],
                                                     device=x.device),
                          0, self.max_len - 1)
        return self._lookup(self.embed, self.ids(x)) \
            + self._lookup(self.pos, pos)

    def apply_decode(self, tokens, t):
        """One decode step's embedding: ``tokens`` (batch,) at per-row
        positions ``t``; returns (batch, 1, embed)."""
        t = torch.as_tensor(t, device=tokens.device).long()
        pos = torch.clamp(t, 0, self.max_len - 1)
        return (self._lookup(self.embed, self.ids(tokens))
                + self._lookup(self.pos, pos))[:, None, :]


class GDCharEmbedding(GradientDescentBase):
    """The vjp of the lookup (a scatter-add into the tables); the ids are
    integral, so no ``err_input`` flows upstream."""


class SeqAll2All(ForwardModule):
    """``y = act(x @ W^T + b)`` at every position: (batch, seq, in) ->
    (batch, seq, width); ``width`` defaults to the input's."""

    ACTIVATION = staticmethod(activations.identity)
    has_weights = True

    def __init__(self, name=None, output_sample_shape=(), **kwargs):
        super().__init__(name=name, **kwargs)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.width = (math.prod(tuple(output_sample_shape))
                      if output_sample_shape else 0)

    @property
    def output_samples_number(self) -> int:
        """The per-position width."""
        return self.width

    def output_shape_for(self, in_shape):
        return (in_shape[0], in_shape[1], self.width)

    def weight_shapes(self, in_shape):
        return (self.width, in_shape[-1]), (self.width,)

    def build(self, in_shape, device):
        if not self.width:
            self.width = int(in_shape[-1])
        return super().build(in_shape, device)

    def forward(self, x):
        return type(self).ACTIVATION(seq_linear(
            x, self.weights, self.bias,
            weights_transposed=self.weights_transposed))


class SeqAll2AllTanh(SeqAll2All):
    ACTIVATION = staticmethod(activations.tanh_scaled)


class SeqAll2AllStrictRELU(SeqAll2All):
    ACTIVATION = staticmethod(activations.strict_relu)


class SeqAll2AllSoftmax(SeqAll2All):
    """The per-position softmax head; the fused forward emits its logits,
    as it does an All2AllSoftmax's."""

    ACTIVATION = staticmethod(activations.softmax)


class GDSeqAll2All(GradientDescentBase):
    """The backward of any SeqAll2All kind: the vjp of its forward."""


class GDSeqSoftmax(GDSeqAll2All):
    """``err_output`` is d(CE)/d(logits): the vjp bypasses the softmax."""

    def backward_apply(self, x):
        m = self.forward.module
        return seq_linear(x, m.weights, m.bias,
                          weights_transposed=m.weights_transposed)
