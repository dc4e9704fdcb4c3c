"""Deterministic procedural datasets (the port's numpy copy of
``digits``, ``tinyimages``, ``kanji``, ``videoframes`` and
``load_or_generate`` in ``znicz_tpu/datasets.py``).

``digits`` draws from the named ``prng`` stream ``dataset.digits``,
``tinyimages`` from ``dataset.tiny``, ``kanji`` from ``dataset.kanji``
(its classes' strokes from ``dataset.kanji.classes``) and
``videoframes`` from ``dataset.video``, exactly as the reference does,
so the same global seed gives the same images and labels bit for bit.
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


def kanji(n: int, *, n_classes: int = 64, size: int = 24,
          noise: float = 0.1, jitter: int = 1,
          stream: str = "dataset.kanji") -> Tuple[np.ndarray, np.ndarray]:
    """n samples of (size, size) float32 in [0,1] + int32 labels over
    ``n_classes`` glyph classes.  Each class is a fixed composition of 4-7
    stroke segments on a 6x6 grid, drawn from the ``<stream>.classes``
    stream so that it does not depend on ``n``; each sample varies by
    stroke thickness, a shift of up to ``jitter`` pixels, brightness and
    pixel noise."""
    rng = prng.get(stream).state
    cls_rng = prng.get(stream + ".classes").state
    grid = 6
    strokes = []
    for _ in range(n_classes):
        segs = []
        for _ in range(int(cls_rng.integers(4, 8))):
            r0 = int(cls_rng.integers(0, grid))
            c0 = int(cls_rng.integers(0, grid))
            horiz = bool(cls_rng.integers(0, 2))
            length = int(cls_rng.integers(2, grid))
            segs.append((r0, c0, horiz, length))
        strokes.append(segs)

    scale = size // grid
    full = grid * scale
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    data = np.zeros((n, size, size), np.float32)
    for i in range(n):
        g = np.zeros((full, full), np.float32)
        thick = int(rng.integers(1, 3))
        for r0, c0, horiz, length in strokes[int(labels[i])]:
            if horiz:
                r = r0 * scale + scale // 2
                g[r:r + thick,
                  c0 * scale:min((c0 + length) * scale, full)] = 1.0
            else:
                c = c0 * scale + scale // 2
                g[r0 * scale:min((r0 + length) * scale, full),
                  c:c + thick] = 1.0
        dy = int(rng.integers(-jitter, jitter + 1))
        dx = int(rng.integers(-jitter, jitter + 1))
        img = np.zeros((size, size), np.float32)
        src = g[:size, :size]
        img[max(dy, 0):size + min(dy, 0), max(dx, 0):size + min(dx, 0)] = \
            src[max(-dy, 0):size + min(-dy, 0),
                max(-dx, 0):size + min(-dx, 0)]
        img *= float(rng.uniform(0.7, 1.0))
        img += rng.normal(0.0, noise, img.shape).astype(np.float32)
        data[i] = np.clip(img, 0.0, 1.0)
    return data, labels


def videoframes(n: int, *, size: int = 16, noise: float = 0.05,
                frames_per_clip: int = 8,
                stream: str = "dataset.video") -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """n (size, size) float32 frames in [0,1] from clips of
    ``frames_per_clip`` frames, and each frame's int32 clip id.  A clip
    is a gaussian blob of fixed width and brightness moving on a straight
    line, with pixel noise on every frame."""
    rng = prng.get(stream).state
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    data = np.zeros((n, size, size), np.float32)
    clip_ids = np.zeros(n, np.int32)
    i = clip = 0
    while i < n:
        x0, y0 = rng.uniform(0.2, 0.8, 2)
        vx, vy = rng.uniform(-0.08, 0.08, 2)
        sigma = float(rng.uniform(0.08, 0.15))
        amp = float(rng.uniform(0.6, 1.0))
        for t in range(min(frames_per_clip, n - i)):
            cx, cy = x0 + vx * t, y0 + vy * t
            img = amp * np.exp(-(np.square(xx - cx) + np.square(yy - cy))
                               / (2 * sigma ** 2))
            img += rng.normal(0.0, noise, img.shape).astype(np.float32)
            data[i] = np.clip(img, 0.0, 1.0)
            clip_ids[i] = clip
            i += 1
        clip += 1
    return data, clip_ids


def load_or_generate(path: Optional[str], generator, *args, **kwargs):
    """If ``path`` exists, load arrays ``data``/``labels`` from the .npz;
    otherwise call the generator."""
    if path and os.path.exists(path):
        with np.load(path) as f:
            return (np.asarray(f["data"], np.float32),
                    np.asarray(f["labels"], np.int32))
    return generator(*args, **kwargs)
