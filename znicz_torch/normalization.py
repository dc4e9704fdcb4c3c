"""Input normalizers (the port's own copy of ``znicz_tpu/normalization.py``,
numpy only).

Strategies match the reference set: none, linear (to [-1,1] range),
mean_disp (subtract mean, divide by dispersion), exp (sigmoid-squash),
pointwise (per-feature linear).  Normalizers are fit on TRAIN data only and
their state is serialized into snapshots so inference-time inputs get the
same transform.  The arithmetic is the reference's line for line, so
``fit`` and ``apply_inplace`` give the same bits on the same array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class NoneNormalizer:
    NAME = "none"

    def fit(self, data: np.ndarray) -> None:
        pass

    def apply_inplace(self, data: np.ndarray) -> None:
        pass

    def state(self) -> Dict:
        return {}

    def restore(self, state: Dict) -> None:
        pass


class LinearNormalizer(NoneNormalizer):
    """Scale to [interval] from the fitted min/max (reference default
    interval (-1, 1))."""

    NAME = "linear"

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(interval)
        self.vmin = None
        self.vmax = None

    def fit(self, data: np.ndarray) -> None:
        self.vmin = float(np.min(data))
        self.vmax = float(np.max(data))

    def apply_inplace(self, data: np.ndarray) -> None:
        lo, hi = self.interval
        span = (self.vmax - self.vmin) or 1.0
        data[...] = (data - self.vmin) / span * (hi - lo) + lo

    def state(self) -> Dict:
        return {"interval": self.interval, "vmin": self.vmin,
                "vmax": self.vmax}

    def restore(self, state: Dict) -> None:
        self.interval = tuple(state["interval"])
        self.vmin = state["vmin"]
        self.vmax = state["vmax"]


class MeanDispNormalizer(NoneNormalizer):
    """Subtract per-feature mean, divide by per-feature dispersion
    (max - min), the reference's image-net-style normalizer."""

    NAME = "mean_disp"

    def __init__(self):
        self.mean = None
        self.disp = None

    def fit(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1)
        self.mean = flat.mean(axis=0).astype(np.float32)
        disp = flat.max(axis=0) - flat.min(axis=0)
        disp[disp == 0] = 1.0
        self.disp = disp.astype(np.float32)

    def apply_inplace(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1)
        flat -= self.mean
        flat /= self.disp

    def state(self) -> Dict:
        return {"mean": self.mean, "disp": self.disp}

    def restore(self, state: Dict) -> None:
        self.mean = np.asarray(state["mean"], np.float32)
        self.disp = np.asarray(state["disp"], np.float32)


class ExpNormalizer(NoneNormalizer):
    """Reference's exponential squash: 2/(1+exp(-x)) - 1."""

    NAME = "exp"

    def apply_inplace(self, data: np.ndarray) -> None:
        data[...] = 2.0 / (1.0 + np.exp(-data)) - 1.0


class PointwiseNormalizer(NoneNormalizer):
    """Per-feature linear map fitted so each feature spans [-1, 1]."""

    NAME = "pointwise"

    def __init__(self):
        self.scale = None
        self.shift = None

    def fit(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1)
        lo, hi = flat.min(axis=0), flat.max(axis=0)
        span = hi - lo
        span[span == 0] = 1.0
        self.scale = (2.0 / span).astype(np.float32)
        self.shift = (-(lo + hi) / span).astype(np.float32)

    def apply_inplace(self, data: np.ndarray) -> None:
        flat = data.reshape(len(data), -1)
        flat *= self.scale
        flat += self.shift

    def state(self) -> Dict:
        return {"scale": self.scale, "shift": self.shift}

    def restore(self, state: Dict) -> None:
        self.scale = np.asarray(state["scale"], np.float32)
        self.shift = np.asarray(state["shift"], np.float32)


NORMALIZERS = {cls.NAME: cls for cls in
               (NoneNormalizer, LinearNormalizer, MeanDispNormalizer,
                ExpNormalizer, PointwiseNormalizer)}


def make(name: str, **kwargs) -> NoneNormalizer:
    return NORMALIZERS[name](**kwargs)
