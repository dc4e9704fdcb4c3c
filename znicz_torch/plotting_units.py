"""Plotting units (port of ``znicz_tpu/plotting_units.py``).

Each plotter is a :meth:`Plotter.snapshot` (plain, picklable data) and a
static ``draw(plt, **data)`` (the one renderer of its figure kind).
``run`` publishes the snapshot to the active
``graphics.GraphicsServer`` when there is one, where a
``GraphicsClient`` renders it with the same ``draw``; otherwise it
renders ``<root.common.dirs.plots>/<name>.png`` itself.

The kinds: error curves (:class:`AccumulatingPlotter`), weight tiles
(:class:`Weights2D`), the confusion matrix (:class:`MatrixPlotter`), a
SOM's hit map (:class:`KohonenHits`) and value histograms
(:class:`MultiHistogram`).

A ``source`` is a ``memory.Array`` (its host half, made current), a
tensor (pulled from its device, bf16 widened to float32), a numpy array,
or a callable returning one of those, called at each snapshot: a
plotter wired to a module's live parameter reads what the last update
left, whichever trainer ran it.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from znicz_torch.core.config import root
from znicz_torch.core.units import Unit

root.common.dirs.defaults({"plots": "plots"})


def host_array(source) -> np.ndarray:
    """``source`` (an ``Array``, a tensor, an array, or a callable
    returning one) as a numpy array on the host."""
    if callable(source):
        source = source()
    if hasattr(source, "map_read"):
        return np.asarray(source.map_read())
    if hasattr(source, "detach"):           # a tensor, maybe on the card
        import torch

        t = source.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(source)


def _plots_dir() -> str:
    d = root.common.dirs.get("plots", "plots")
    os.makedirs(d, exist_ok=True)
    return d


class Plotter(Unit):
    """Base: gathers a plain-data ``snapshot`` and either streams it to
    the active ``GraphicsServer`` or renders it into
    ``<plots>/<name>.png``; ``render=False`` only snapshots."""

    def __init__(self, workflow=None, name=None, render=True, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.render = render

    def path(self) -> str:
        return os.path.join(_plots_dir(), f"{self.name}.png")

    def snapshot(self) -> dict:
        """Plain arrays and scalars for ``draw``; picklable."""
        raise NotImplementedError

    @staticmethod
    def draw(plt, **data) -> None:
        """The renderer, shared by the offline path and the live
        client."""
        raise NotImplementedError

    @classmethod
    def render_png(cls, data: dict, path: str) -> None:
        """The figure's scaffolding (backend, size, save options), one
        for the offline path and the live client."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 4), dpi=96)
        try:
            cls.draw(plt, **data)
            fig.savefig(path, bbox_inches="tight")
        finally:
            plt.close(fig)

    def run(self):
        # the snapshot comes before the render gate: an accumulating
        # plotter keeps its series with render=False too
        data = self.snapshot()
        if not self.render:
            return
        from znicz_torch.graphics import GraphicsServer

        server = GraphicsServer.active()
        if server is not None:
            server.publish({"kind": "figure", "cls": type(self).__name__,
                            "name": self.name, "data": data})
            return
        self.render_png(data, self.path())


class AccumulatingPlotter(Plotter):
    """An error or loss curve: appends ``fetch()`` (a float, such as an
    epoch's metric of the Decision) at every run."""

    def __init__(self, workflow=None, name=None, fetch=None, ylabel="value",
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.fetch = fetch
        self.ylabel = ylabel
        self.values: List[float] = []

    def snapshot(self) -> dict:
        if self.fetch is not None:
            self.values.append(float(self.fetch()))
        return {"values": list(self.values), "ylabel": self.ylabel}

    @staticmethod
    def draw(plt, values=(), ylabel="value"):
        plt.plot(values, marker="o", ms=3)
        plt.xlabel("epoch")
        plt.ylabel(ylabel)
        plt.grid(True, alpha=0.3)


class Weights2D(Plotter):
    """Weight tiles: the first ``limit`` rows of a weight matrix, each
    reshaped to ``sample_shape`` and tiled into one image."""

    def __init__(self, workflow=None, name=None, source=None,
                 sample_shape=None, limit=64, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.source = source
        self.sample_shape = sample_shape
        self.limit = int(limit)

    def snapshot(self) -> dict:
        w = host_array(self.source)
        return {"weights": w.reshape(w.shape[0], -1)[:self.limit].copy(),
                "sample_shape": self.sample_shape}

    @staticmethod
    def draw(plt, weights=None, sample_shape=None):
        w = np.asarray(weights)
        shape = tuple(sample_shape) if sample_shape else (
            int(np.sqrt(w.shape[1])), int(np.sqrt(w.shape[1])))
        n = w.shape[0]
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        tile = np.zeros((rows * shape[0], cols * shape[1]), np.float32)
        for i in range(n):
            r, c = divmod(i, cols)
            img = w[i][:shape[0] * shape[1]].reshape(shape)
            tile[r * shape[0]:(r + 1) * shape[0],
                 c * shape[1]:(c + 1) * shape[1]] = img
        plt.imshow(tile, cmap="gray")
        plt.axis("off")


class MatrixPlotter(Plotter):
    """A confusion matrix's heat map."""

    def __init__(self, workflow=None, name=None, fetch=None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.fetch = fetch

    def snapshot(self) -> dict:
        return {"matrix": host_array(self.fetch())}

    @staticmethod
    def draw(plt, matrix=None):
        plt.imshow(np.asarray(matrix), cmap="viridis")
        plt.colorbar()
        plt.xlabel("target")
        plt.ylabel("predicted")


class KohonenHits(Plotter):
    """A SOM's hit map: each neuron's winner count on its (sy, sx)
    grid."""

    def __init__(self, workflow=None, name=None, forward=None, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.forward = forward

    def snapshot(self) -> dict:
        f = self.forward
        return {"hits": host_array(f.hits).reshape(f.sy, f.sx),
                "total": int(f.total)}

    @staticmethod
    def draw(plt, hits=None, total=0):
        plt.imshow(np.asarray(hits), cmap="hot")
        plt.colorbar()
        plt.title(f"hits (total {total})")


class MultiHistogram(Plotter):
    """A histogram of a tensor's values."""

    def __init__(self, workflow=None, name=None, source=None, bins=50,
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.source = source
        self.bins = int(bins)

    def snapshot(self) -> dict:
        return {"values": host_array(self.source).reshape(-1),
                "bins": self.bins}

    @staticmethod
    def draw(plt, values=None, bins=50):
        plt.hist(np.asarray(values), bins=int(bins))
        plt.grid(True, alpha=0.3)
