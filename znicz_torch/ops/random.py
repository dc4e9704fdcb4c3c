"""The counter-based random stream of the generation sampler: the
reference's ``jax.random`` threefry-2x32 (``fold_in``, ``bits``,
``gumbel``) in torch integer ops.

Threefry is a pure function of ``(key, counter)``: no generator state, so
a sampled token depends on its own ``(seed, position)`` only, never on
its co-batched neighbours, and the sampler can sit inside a captured CUDA
graph.  The arithmetic is uint32's, carried in int64 tensors and masked
to 32 bits after every add and rotate (torch has no uint32 arithmetic on
every device).  ``bits`` follows the partitionable form
(``jax_threefry_partitionable``, the default since jax 0.5): element
``i`` of a draw is the two output words of the counter ``(0, i)`` XORed.
The float view of ``(bits >> 9) | 0x3f800000`` goes through int32, which
holds it.

The same seeds and positions give the reference's bits exactly, so the
port's sampled tokens equal the reference's on identical logits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
#: the two rotation schedules of threefry-2x32's 20 rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key-schedule parity constant
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``: int64 tensors (or ints) holding uint32
    values, broadcast together.  Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64) & _MASK
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64, device=k0.device)
          + ks[0]) & _MASK
    x1 = (torch.as_tensor(x1, dtype=torch.int64, device=k0.device)
          + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(seed, pos):
    """The key of ``fold_in(PRNGKey(seed), pos)``: the key ``(0, seed)``
    applied to the counter ``(0, pos)``.  ``seed`` and ``pos`` are int64
    tensors (or ints) of uint32 values; returns the key's two words."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return threefry2x32(torch.zeros_like(seed), seed, torch.zeros_like(seed),
                        pos)


def bits(key, v: int) -> torch.Tensor:
    """``jax.random.bits(key, (v,), uint32)`` of each key: ``key`` is the
    word pair of :func:`fold_in` over (b,) rows; returns (b, v) int64
    holding uint32 values."""
    k0, k1 = key
    i = torch.arange(v, dtype=torch.int64, device=k0.device)[None, :]
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key, v: int) -> torch.Tensor:
    """``jax.random.uniform(key, (v,), float32, minval=tiny, maxval=1)``:
    the top 23 bits as the mantissa of a float in [1, 2), less 1, plus
    tiny, floored at tiny."""
    tiny = torch.finfo(torch.float32).tiny
    mant = ((bits(key, v) >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    return torch.clamp_min(u + tiny, tiny)


def gumbel(key, v: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (v,), float32)`` of each key: (b, v)
    float32 ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(key, v)))
