"""Deterministic procedural datasets (the port's numpy copy of
``digits``, ``tinyimages`` and ``load_or_generate`` in
``znicz_tpu/datasets.py``).

``digits`` draws from the named ``prng`` stream ``dataset.digits`` and
``tinyimages`` from ``dataset.tiny``, exactly as the reference does, so
the same global seed gives the same images and labels bit for bit.
``load_or_generate`` reads a real .npz (arrays ``data``/``labels``)
when its path exists.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from znicz_torch.core import prng

# 5x7 digit font (rows of 5 bits, 0..9).
_FONT = {
    0: ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    1: ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    2: ("01110", "10001", "00001", "00110", "01000", "10000", "11111"),
    3: ("01110", "10001", "00001", "00110", "00001", "10001", "01110"),
    4: ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    5: ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    6: ("01110", "10000", "11110", "10001", "10001", "10001", "01110"),
    7: ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    8: ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    9: ("01110", "10001", "10001", "01111", "00001", "00001", "01110"),
}


def _glyph(digit: int) -> np.ndarray:
    rows = _FONT[digit]
    return np.array([[float(c) for c in row] for row in rows], np.float32)


def digits(n: int, *, size: int = 28, noise: float = 0.15, jitter: int = 2,
           stream: str = "dataset.digits") -> Tuple[np.ndarray, np.ndarray]:
    """n samples of (size, size) float32 in [0,1] + int32 labels: glyphs
    of a 5x7 font, upscaled 2x or 3x, roughly centred with a shift of up
    to ``jitter`` pixels, a random brightness, and pixel noise."""
    gen = prng.get(stream)
    rng = gen.state
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    data = np.zeros((n, size, size), np.float32)
    for i in range(n):
        g = _glyph(int(labels[i]))
        scale = int(rng.integers(2, 4))                 # 2x or 3x upscale
        big = np.kron(g, np.ones((scale, scale), np.float32))
        h, w = big.shape
        cr, cc = (size - h) // 2, (size - w) // 2
        r = int(np.clip(cr + rng.integers(-jitter, jitter + 1),
                        0, size - h))
        c = int(np.clip(cc + rng.integers(-jitter, jitter + 1),
                        0, size - w))
        img = np.zeros((size, size), np.float32)
        img[r:r + h, c:c + w] = big * float(rng.uniform(0.6, 1.0))
        img += rng.normal(0.0, noise, size=(size, size)).astype(np.float32)
        data[i] = np.clip(img, 0.0, 1.0)
    return data, labels


def tinyimages(n: int, *, size: int = 32, noise: float = 0.25,
               stream: str = "dataset.tiny") -> Tuple[np.ndarray, np.ndarray]:
    """n samples of (size, size, 3) float32 in [0,1] + int32 labels.
    Classes are parametric textures: oriented sinusoid gratings (0-4) and
    gaussian blobs at class-coded positions (5-9); colour, frequency,
    channel and blob width are nuisances, and every image gets a faint
    distractor grating plus pixel noise."""
    gen = prng.get(stream)
    rng = gen.state
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    data = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        k = int(labels[i])
        img = np.zeros((size, size, 3), np.float32)
        phase = float(rng.uniform(0, 2 * np.pi))
        if k < 5:
            angle = k * np.pi / 5 + float(rng.normal(0, 0.10))
            freq = float(rng.uniform(3.0, 6.0))
            wave = 0.5 + 0.5 * np.sin(
                2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle))
                + phase)
            color = rng.uniform(0.5, 1.0, 3).astype(np.float32)
            img = wave[..., None] * color
        else:
            cx = 0.25 + 0.125 * (k - 5) + float(rng.normal(0, 0.04))
            cy = 0.35 + 0.08 * (k - 5) + float(rng.normal(0, 0.04))
            sigma = float(rng.uniform(0.08, 0.16))
            blob = np.exp(-(np.square(xx - cx) + np.square(yy - cy))
                          / (2 * sigma ** 2))
            chan = int(rng.integers(0, 3))
            img[..., chan] = blob
            img[..., (chan + 1) % 3] = 0.3 * blob
        dang = float(rng.uniform(0, np.pi))
        dfreq = float(rng.uniform(3.0, 6.0))
        dphase = float(rng.uniform(0, 2 * np.pi))
        dist = 0.5 + 0.5 * np.sin(
            2 * np.pi * dfreq * (xx * np.cos(dang) + yy * np.sin(dang))
            + dphase)
        img += 0.10 * dist[..., None] * \
            rng.uniform(0.3, 1.0, 3).astype(np.float32)
        img += rng.normal(0.0, noise, size=img.shape).astype(np.float32)
        data[i] = np.clip(img, 0.0, 1.0)
    return data, labels


def load_or_generate(path: Optional[str], generator, *args, **kwargs):
    """If ``path`` exists, load arrays ``data``/``labels`` from the .npz;
    otherwise call the generator."""
    if path and os.path.exists(path):
        with np.load(path) as f:
            return (np.asarray(f["data"], np.float32),
                    np.asarray(f["labels"], np.int32))
    return generator(*args, **kwargs)
