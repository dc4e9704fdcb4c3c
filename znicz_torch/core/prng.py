"""Seeded PRNG service — the port's own copy of ``znicz_tpu/core/prng.py``.

Named host streams: ``get(name)`` returns a :class:`RandomGenerator` whose
numpy Generator is seeded by a hash of (global seed, name).  The streams
are copied exactly, so dataset generation and loader shuffles are
bit-identical to the reference's.

Device randomness (dropout masks) comes from :meth:`RandomGenerator.
torch_generator`: a ``torch.Generator`` on the target device seeded from
(stream seed, step, layer index).  On a GPU that generator is Philox, not
the reference's threefry, so masks differ from the reference's by design;
tests that compare masks inject the reference's own.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np


def _derive_seed(global_seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{global_seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


class RandomGenerator:
    """One named random stream: numpy host RNG + torch device generators."""

    def __init__(self, name: str, seed: int) -> None:
        self.name = name
        self.seed = _derive_seed(seed, name)
        self.state = np.random.default_rng(self.seed)

    # -- host-side (numpy) ---------------------------------------------------

    def uniform(self, low: float, high: float, shape, dtype=np.float32):
        return self.state.uniform(low, high, size=shape).astype(dtype)

    def normal(self, stddev: float, shape, dtype=np.float32):
        return self.state.normal(0.0, stddev, size=shape).astype(dtype)

    def permutation(self, n: int) -> np.ndarray:
        return self.state.permutation(n)

    # -- device-side (torch) -------------------------------------------------

    def torch_generator(self, step: int, index: int = 0, device="cpu"):
        """A ``torch.Generator`` on ``device`` seeded from (stream seed,
        step, layer index): the same triple always gives the same draws
        on the same device, so a mask can be regenerated instead of
        stored."""
        import torch

        gen = torch.Generator(device=device)
        gen.manual_seed(_derive_seed(self.seed, f"step{int(step)}."
                                                f"layer{int(index)}"))
        return gen

    def reseed(self, seed: int) -> None:
        self.seed = _derive_seed(seed, self.name)
        self.state = np.random.default_rng(self.seed)


_streams: Dict[str, RandomGenerator] = {}
_global_seed: int | None = None


def _seed() -> int:
    global _global_seed
    if _global_seed is None:
        from znicz_torch.core.config import root

        _global_seed = int(root.common.engine.get("seed", 1013))
    return _global_seed


def get(name: str = "default") -> RandomGenerator:
    """Return (creating on first use) the named stream."""
    stream = _streams.get(name)
    if stream is None:
        stream = RandomGenerator(name, _seed())
        _streams[name] = stream
    return stream


def seed_all(seed: int) -> None:
    """Reset the global seed and reseed every existing stream."""
    global _global_seed
    _global_seed = int(seed)
    from znicz_torch.core.config import root

    root.common.engine.seed = int(seed)
    for stream in _streams.values():
        stream.reseed(_global_seed)


def reset(seed: int) -> None:
    """Drop every named stream and reseed: the state of a fresh process
    started with this global seed."""
    _streams.clear()
    seed_all(seed)
