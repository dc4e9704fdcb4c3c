"""Streaming loaders: a dataset served from a host source in one of three
residencies (port of ``znicz_tpu/loader/streaming.py``).

  1. **float32 resident**: the source's float32 rows are copied to the
     device once and ``FusedTrainer`` gathers minibatches there, as from
     a ``FullBatchLoader``;
  2. **uint8 resident**: the rows stay uint8 on the device, a quarter of
     the bytes, and the step decodes each gathered minibatch to
     ``u8 * scale + shift`` in float32 (``FusedTrainer._decode``);
  3. **host staged**: the rows stay on the host (an array, a memmap, or
     image files decoded when a segment needs them) and the trainer
     stages each segment of k minibatches: the rows gathered into pinned
     memory in their storage dtype, copied to the device on a copy
     stream while the previous segment runs, decoded there.  A
     ``DecodePool`` (``loader/ingest.py``) decodes an image source's rows
     in parallel, and the trainer's lookahead submits them a segment or
     two ahead.

``initialize`` picks the residency: a source whose bytes fit
``device_budget_bytes`` (the keyword, else ``root.common.engine.
stream_budget_mb``, else 4 GiB) is resident, a larger one is staged.  The
decode is linear; a normalizer is refused (``ValueError``), as the
reference refuses it, and an MSE run without targets is refused by the
trainer.  The unit engine reads the same loader through
:meth:`StreamingLoader.fill_minibatch`: the host gather, the decode on
the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from znicz_torch.loader.base import Loader
from znicz_torch.loader.fullbatch import device_index
from znicz_torch.memory import Array

#: the device budget of a resident dataset, in bytes, unless the keyword
#: or ``root.common.engine.stream_budget_mb`` names one
DEFAULT_DEVICE_BUDGET = 4 << 30


class HostArraySource:
    """A sample-major numpy array (or memmap) as a source: uint8 and
    float32 keep their dtype, anything else becomes float32.  Rows are
    made contiguous (a copy only of a strided array), so that a gather
    copies whole rows."""

    def __init__(self, data: np.ndarray, labels: Optional[np.ndarray] = None,
                 targets: Optional[np.ndarray] = None):
        if data.dtype not in (np.uint8, np.float32):
            data = np.asarray(data, np.float32)
        self.data = np.ascontiguousarray(data)
        self.labels = (None if labels is None
                       else np.asarray(labels, np.int32))
        self.targets = (None if targets is None
                        else np.asarray(targets, np.float32))

    def __len__(self) -> int:
        return len(self.data)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[1:])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)

    def gather(self, idx: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """The rows of ``idx`` in the storage dtype, into ``out`` when it
        is given (written in place: the indices are checked first, so the
        take needs no buffer of its own)."""
        idx = np.asarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.data)):
            raise IndexError(f"gather index out of range [0, "
                             f"{len(self.data)})")
        return np.take(self.data, idx, axis=0, out=out, mode="clip")

    def whole(self) -> np.ndarray:
        return np.ascontiguousarray(self.data)


class ImageFileSource:
    """Image files decoded when a segment needs them, as uint8 resized to
    ``target_shape`` = (H, W); ``paths`` and ``labels`` aligned.  The
    decode runs on a ``DecodePool`` of ``workers`` threads (default
    ``root.common.engine.decode_workers``, else one a CPU); ``workers=0``
    decodes serially.  Both give the same bytes."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 target_shape: Tuple[int, int], grayscale: bool = False,
                 workers: Optional[int] = None):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths but {len(labels)} labels")
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.target_shape = tuple(target_shape)
        self.grayscale = bool(grayscale)
        self.targets = None
        self.workers = workers
        self._pool = None

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        h, w = self.target_shape
        return (h, w) if self.grayscale else (h, w, 3)

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    @property
    def nbytes(self) -> int:
        return len(self) * int(np.prod(self.sample_shape))

    def _decode_row(self, i: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.paths[i]) as img:
            img = img.convert("L" if self.grayscale else "RGB")
            img = img.resize((self.target_shape[1], self.target_shape[0]))
            return np.asarray(img, np.uint8)

    def pool(self):
        """The decode pool, made at first use; None when ``workers`` is
        0.  One worker still decodes prefetched rows while the training
        thread waits on the device."""
        if self._pool is None:
            from znicz_torch.loader.ingest import DecodePool, default_workers

            w = default_workers() if self.workers is None \
                else int(self.workers)
            if w < 1:
                return None
            self._pool = DecodePool(self._decode_row, workers=w)
        return self._pool

    def with_workers(self, workers: int) -> "ImageFileSource":
        """The same files with another worker count."""
        return ImageFileSource(self.paths, self.labels, self.target_shape,
                               self.grayscale, workers=workers)

    def prefetch(self, idx: np.ndarray) -> int:
        """Start decoding rows a later gather needs; returns the count
        newly submitted."""
        pool = self.pool()
        return pool.submit(idx) if pool is not None else 0

    @property
    def ingest_stats(self) -> Optional[dict]:
        return None if self._pool is None else dict(self._pool.stats)

    def gather(self, idx: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        pool = self.pool()
        rows = (pool.take(idx) if pool is not None else
                np.stack([self._decode_row(int(i)) for i in idx]))
        if out is None:
            return rows
        out[...] = rows
        return out

    def whole(self) -> np.ndarray:
        return self.gather(np.arange(len(self)))


class StreamingLoader(Loader):
    """A loader over a host ``source`` (a :class:`HostArraySource`, an
    :class:`ImageFileSource`, or a numpy array, which is wrapped).
    ``class_lengths`` is the [test, valid, train] split (default: all
    TRAIN); ``scale`` and ``shift`` the decode of uint8 rows;
    ``device_budget_bytes`` the most a resident dataset may take on the
    device."""

    streaming = True

    def __init__(self, workflow=None, name: str = "loader", source=None,
                 class_lengths=None, scale: float = 1.0 / 255.0,
                 shift: float = 0.0, device_budget_bytes=None,
                 normalizer=None, **kwargs):
        if normalizer is not None:
            raise ValueError(
                f"{name}: a streaming loader decodes linearly (u8 * scale "
                "+ shift); a normalizer needs the float32 FullBatchLoader")
        super().__init__(workflow=workflow, name=name, **kwargs)
        if isinstance(source, np.ndarray):
            source = HostArraySource(source)
        self.source = source
        self._class_lengths_arg = class_lengths
        self.scale = float(scale)
        self.shift = float(shift)
        self.device_budget_bytes = device_budget_bytes
        #: set by initialize: True when ``data`` holds the whole dataset
        #: on the device in its storage dtype
        self.device_resident = False
        self.original_labels: Optional[np.ndarray] = None
        self.original_targets: Optional[np.ndarray] = None
        self.data: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.targets: Optional[torch.Tensor] = None
        self.minibatch_targets = Array()
        self._device = torch.device("cpu")

    # -- geometry and residency ------------------------------------------------

    def _budget(self) -> int:
        if self.device_budget_bytes is not None:
            return int(self.device_budget_bytes)
        from znicz_torch.core.config import root

        mb = root.common.engine.get("stream_budget_mb", None)
        return (int(mb) << 20) if mb is not None else DEFAULT_DEVICE_BUDGET

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.source.sample_shape)

    def load_data(self) -> None:
        if self.source is None:
            raise ValueError(f"{self.name}: source not set")
        n = len(self.source)
        if self._class_lengths_arg is not None:
            self.class_lengths = [int(c) for c in self._class_lengths_arg]
            if sum(self.class_lengths) != n:
                raise ValueError(f"{self.name}: class_lengths "
                                 f"{self.class_lengths} != {n} samples")
        else:
            self.class_lengths = [0, 0, n]
        if self.source.labels is not None:
            self.original_labels = np.asarray(self.source.labels, np.int32)
        if getattr(self.source, "targets", None) is not None:
            self.original_targets = np.asarray(self.source.targets,
                                               np.float32)
        self.device_resident = self.source.nbytes <= self._budget()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = torch.device("cpu" if device is None else device)
        self._device = dev
        if self.original_labels is not None:
            self.labels = torch.from_numpy(
                self.original_labels.astype(np.int64)).to(dev)
        if self.original_targets is not None:
            self.targets = torch.from_numpy(self.original_targets).to(dev)
        if self.device_resident:
            self.data = torch.from_numpy(self.source.whole()).to(dev)
        self.minibatch_targets.initialize(device)
        self.minibatch_data.mem = np.zeros(
            (self.max_minibatch_size,) + self.sample_shape, np.float32)

    def train_labels(self):
        return self.original_labels

    @property
    def decode_needed(self) -> bool:
        return self.source.dtype == np.uint8

    # -- the resident gather (FusedTrainer) ------------------------------------

    def gather(self, idx) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(data rows in the storage dtype, label rows) of a resident
        dataset, on the device."""
        if self.data is None:
            raise ValueError(f"{self.name}: the dataset is host-staged; "
                             "stage its rows with host_gather")
        idx = device_index(idx, self.data.device)
        return (self.data.index_select(0, idx),
                None if self.labels is None
                else self.labels.index_select(0, idx))

    def gather_targets(self, idx, rows=None) -> torch.Tensor:
        return self.targets.index_select(
            0, device_index(idx, self.targets.device))

    # -- the host surface (staging) --------------------------------------------

    def host_gather(self, idx, out: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Rows of global indices in the storage dtype (uint8 crosses to
        the device as uint8), into ``out`` when it is given."""
        return self.source.gather(np.asarray(idx, np.int32), out=out)

    def host_gather_labels(self, idx) -> np.ndarray:
        return np.take(self.original_labels, np.asarray(idx, np.int64),
                       axis=0)

    def host_gather_targets(self, idx) -> np.ndarray:
        return np.ascontiguousarray(np.take(
            self.original_targets, np.asarray(idx, np.int64), axis=0))

    def prefetch_rows(self, idx) -> int:
        """Start decoding rows a later ``host_gather`` needs (a source
        with a decode pool); 0 for a source without."""
        fn = getattr(self.source, "prefetch", None)
        return int(fn(np.asarray(idx, np.int32))) if fn is not None else 0

    @property
    def ingest_stats(self) -> Optional[dict]:
        """The decode pool's counters, or None without a pool."""
        return getattr(self.source, "ingest_stats", None)

    # -- the unit engine -------------------------------------------------------

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        """uint8 rows as ``u8 * scale + shift`` in float32, as the fused
        step decodes them; float32 rows as they are."""
        if rows.dtype == torch.uint8:
            return rows.to(torch.float32) * self.scale + self.shift
        return rows

    def fill_minibatch(self) -> None:
        """The host gather of the current minibatch, decoded on the
        device, into the minibatch Arrays."""
        idx = np.asarray(self.minibatch_indices, np.int32)
        rows = torch.from_numpy(self.host_gather(idx)).to(self._device)
        self.minibatch_data.devmem = self.decode(rows)
        if self.original_labels is not None:
            self.minibatch_labels.devmem = torch.from_numpy(
                self.host_gather_labels(idx).astype(np.int64)).to(
                    self._device)
        if self.original_targets is not None:
            self.minibatch_targets.devmem = torch.from_numpy(
                self.host_gather_targets(idx)).to(self._device)


def class_dir_source(base: str, target_shape: Tuple[int, int],
                     grayscale: bool = False,
                     workers: Optional[int] = None) -> ImageFileSource:
    """``<base>/<class>/<image>`` as an :class:`ImageFileSource` (the
    directory layout of ``loader/image.py``, decoded on demand)."""
    from znicz_torch.loader.image import scan_class_dirs

    paths, labels, _ = scan_class_dirs(base)
    return ImageFileSource(paths, labels, target_shape, grayscale,
                           workers=workers)

