"""Attention ops (port of ``znicz_tpu/ops/attention.py``).

  - :func:`attention` — exact scaled-dot-product attention with optional
    causal masking at global positions (scalar or per-row offsets) and a
    ``k_valid`` key mask;
  - :func:`cache_append` / :func:`decode_attention` — one decode step
    over a preallocated (batch, cache_len, heads, dim) cache;
  - :func:`paged_gather` / :func:`paged_append` /
    :func:`paged_decode_attention` — the same over a block-paged pool
    ``(num_pages + 1, page_size, heads, dim)`` whose last page is pad
    scratch, rows addressed through a (batch, P) page table at GLOBAL
    positions;
  - :func:`ring_attention` — exact attention over a sequence split in
    consecutive blocks across the ranks of a process group: each rank
    attends its query block to one key/value block a step, folds it into
    flash-style float32 accumulators and passes the block to the next
    rank (``parallel/mesh.ring_shift``), n steps for n ranks.

The arithmetic is the reference's, in its order: the score einsum over
``sqrt(d)``, masked scores filled with ``finfo(dtype).min`` (never
``-inf``), ``exp(s - max)``, masked probabilities zeroed, the
denominator clamped at ``finfo.tiny``, the value einsum.  A query row
whose keys are all masked returns zeros, not NaN.  It is written in
plain tensor ops rather than ``F.scaled_dot_product_attention``, whose
fused kernels reduce in another order and treat an all-masked row
otherwise.

Shapes: (batch, seq, heads, head_dim) throughout.  Indices are assumed
in range: torch's indexing raises where ``jnp.take`` would clamp.
"""

from __future__ import annotations

import math
import numbers

import torch


def _positions(offset, n: int, device) -> torch.Tensor:
    """(1, n) global positions from a scalar offset, (batch, n) from a
    per-row (batch,) offset."""
    if isinstance(offset, numbers.Integral):
        start = int(offset)
        return torch.arange(start, start + n, device=device)[None]
    offset = torch.as_tensor(offset, device=device)
    pos = offset[..., None] + torch.arange(n, device=device)
    return pos[None] if pos.ndim == 1 else pos


def attention(q, k, v, causal: bool = False, q_offset=0, k_offset=0,
              k_valid=None):
    """Exact attention of ``q`` over ``k``/``v``.  With ``causal`` a key is
    masked where its global position (``k_offset`` + index) is past the
    query's (``q_offset`` + index); offsets are ints or per-row (batch,)
    tensors.  ``k_valid`` is an optional (batch, k) bool mask of the keys
    that exist.  Rows with at least one valid key equal the unguarded
    softmax bit for bit; an all-masked row gives zeros."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    dead = None                                        # (b, h, q, k) bcast
    if causal:
        qpos = _positions(q_offset, q.shape[1], s.device)
        kpos = _positions(k_offset, k.shape[1], s.device)
        dead = kpos[:, None, None, :] > qpos[:, None, :, None]
    if k_valid is not None:
        miss = ~torch.as_tensor(k_valid, device=s.device)[:, None, None, :]
        dead = miss if dead is None else (dead | miss)
    if dead is not None:
        s = torch.where(dead, torch.finfo(s.dtype).min, s)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    if dead is not None:
        p = torch.where(dead, 0.0, p)
    denom = torch.sum(p, dim=-1, keepdim=True)
    if dead is not None:
        denom = torch.clamp_min(denom, torch.finfo(p.dtype).tiny)
    p = p / denom
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def cache_append(cache, row, t):
    """``cache`` (batch, cache_len, heads, dim) with the (batch, heads,
    dim) ``row`` written at per-row position ``t`` ((batch,) ints).
    Pure: returns a new tensor."""
    t = torch.as_tensor(t, device=cache.device).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((rows, t), row)


def decode_attention(q1, k_cache, v_cache, t):
    """One decode step: the (batch, 1, heads, dim) query at per-row
    position ``t`` attends cache positions ``[0..t]``; the unwritten tail
    is masked by ``k_valid``.  The caller appends this step's key and
    value first, so every row keeps at least one valid key."""
    t = torch.as_tensor(t, device=k_cache.device)
    k_valid = torch.arange(k_cache.shape[1],
                           device=k_cache.device)[None, :] <= t[:, None]
    return attention(q1, k_cache, v_cache, k_valid=k_valid)


def paged_gather(pool, table):
    """Each row's contiguous (batch, P * page_size, heads, dim) view of the
    paged ``pool``: position ``t`` of row ``i`` is page ``table[i, t //
    page_size]``, offset ``t % page_size``."""
    table = torch.as_tensor(table, device=pool.device).long()
    b, npages = table.shape
    page_size = pool.shape[1]
    return pool[table].reshape(b, npages * page_size, pool.shape[2],
                               pool.shape[3])


def paged_append(pool, table, row, t):
    """``pool`` with the (batch, heads, dim) ``row`` written at per-row
    GLOBAL position ``t``: page ``table[i, t // page_size]``, offset ``t %
    page_size``.  Pure; a pad row whose table entry is the scratch page
    writes there and never touches a real page."""
    table = torch.as_tensor(table, device=pool.device).long()
    t = torch.as_tensor(t, device=pool.device).long()
    b, npages = table.shape
    page_size = pool.shape[1]
    rows = torch.arange(b, device=pool.device)
    page = table[rows, torch.clamp(t // page_size, 0, npages - 1)]
    return pool.index_put((page, t % page_size), row)


def paged_decode_attention(q1, k_pool, v_pool, table, t):
    """:func:`decode_attention` over the paged pool: each row's pages
    gathered into its contiguous view, then the same masked softmax over
    ``[0..t]``."""
    return decode_attention(q1, paged_gather(k_pool, table),
                            paged_gather(v_pool, table), t)


def ring_attention(q, k, v, group, causal: bool = False):
    """Exact attention of this rank's (batch, T/n, heads, dim) query block
    over the whole sequence, whose n consecutive blocks lie on the ranks
    of ``group`` in rank order (None: one rank, the whole sequence).  The
    reference's loop in its order and constants: at step ``i`` the block
    held came from rank ``(my - i) % n``; causal scores past the query's
    global position take ``finfo(float32).min`` and their probabilities
    are zeroed; the running max ``m``, denominator ``l`` and accumulator
    are float32, rescaled by ``exp(m - m_new)``; the output divides by
    ``max(l, 1e-30)``.  The keys and values travel as one stacked tensor,
    and the last step sends nothing (the reference's last ``ppermute``
    feeds no later step).  Autograd through the shifts gives the
    reference's gradient."""
    from znicz_torch.parallel.mesh import ring_shift

    n = 1 if group is None else torch.distributed.get_world_size(group)
    my = 0 if group is None else torch.distributed.get_rank(group)
    b, t, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    neg = torch.finfo(torch.float32).min
    qpos = my * t + torch.arange(t, device=dev)       # global q positions
    m = torch.full((b, h, t), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (my - i) % n                             # who produced kv
        k_blk, v_blk = kv[0], kv[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
        kmask = None
        if causal:
            kpos = src * t + torch.arange(t, device=dev)
            kmask = kpos[None, None, None, :] > qpos[None, None, :, None]
            s = torch.where(kmask, neg, s)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        if kmask is not None:
            # a wholly masked block leaves m_new at neg, where exp(0) = 1
            # would leak mass
            p = torch.where(kmask, 0.0, p)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.to(p.dtype))
        m = m_new
        if i + 1 < n:
            kv = ring_shift(kv, group)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (b, h, q, d)
    return out.transpose(1, 2)                        # (b, q, h, d)
