"""Image-file loaders (port of ``znicz_tpu/loader/image.py``).

:class:`FullBatchFileImageLoader` reads directories of class
subdirectories of image files, decodes each file with PIL (imported
when the first image is decoded, as the reference does), resizes it to
``target_shape`` and turns its bytes into float32 in [0, 1] through the
host runtime's ``u8_to_f32`` (:func:`decode_image`), and serves them as
a device-resident full batch.  Class indices come from the TRAIN
directory's sorted class names; a class in another split that train does
not have raises ``ValueError`` instead of taking a new index.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from znicz_torch import native
from znicz_torch.loader.fullbatch import FullBatchLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm")


def decode_image(path: str, target_shape: Tuple[int, int],
                 grayscale: bool = False) -> np.ndarray:
    """One image file as (H, W) float32 (``grayscale``) or (H, W, 3), in
    [0, 1], resized to ``target_shape`` = (H, W)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("L" if grayscale else "RGB")
        img = img.resize((target_shape[1], target_shape[0]))
        arr = np.asarray(img, np.uint8)
    return native.u8_to_f32(arr)


def scan_class_dirs(base: str, exts: Sequence[str] = IMAGE_EXTS
                    ) -> Tuple[List[str], List[int], List[str]]:
    """``<base>/<class name>/<file>`` -> (paths, labels, class names):
    classes in sorted order, each one's files sorted, only the files with
    an extension of ``exts`` (any case)."""
    class_names = sorted(d for d in os.listdir(base)
                         if os.path.isdir(os.path.join(base, d)))
    paths, labels = [], []
    for ci, cname in enumerate(class_names):
        cdir = os.path.join(base, cname)
        for fname in sorted(os.listdir(cdir)):
            if os.path.splitext(fname)[1].lower() in exts:
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, class_names


class FullBatchFileImageLoader(FullBatchLoader):
    """``train_path`` (required), ``valid_path`` and ``test_path``, each a
    directory of class subdirectories; ``target_shape`` = (H, W);
    ``grayscale`` gives (H, W) samples, else (H, W, 3)."""

    def __init__(self, workflow=None, name: str = "loader",
                 train_path: Optional[str] = None,
                 valid_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 target_shape=(32, 32), grayscale: bool = False, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.train_path = train_path
        self.valid_path = valid_path
        self.test_path = test_path
        self.target_shape = tuple(target_shape)
        self.grayscale = bool(grayscale)
        self.class_names: Optional[List[str]] = None

    def _sample_shape(self) -> Tuple[int, ...]:
        h, w = self.target_shape
        return (h, w) if self.grayscale else (h, w, 3)

    def _load_split(self, base: Optional[str]):
        """(data, labels) of the split under ``base`` (empty without
        one), labelled by the train directory's class names."""
        empty = (np.zeros((0,) + self._sample_shape(), np.float32),
                 np.zeros(0, np.int32))
        if not base:
            return empty
        paths, local_labels, names = scan_class_dirs(base)
        index_of = {n: i for i, n in enumerate(self.class_names)}
        unknown = [n for n in names if n not in index_of]
        if unknown:
            raise ValueError(
                f"{self.name}: classes {unknown} in {base} are absent from "
                f"train_path (classes: {self.class_names})")
        if not paths:
            return empty
        data = np.stack([decode_image(p, self.target_shape, self.grayscale)
                         for p in paths])
        return (data.astype(np.float32),
                np.asarray([index_of[names[k]] for k in local_labels],
                           np.int32))

    def load_data(self):
        if not self.train_path:
            raise ValueError(f"{self.name}: train_path required")
        _, _, self.class_names = scan_class_dirs(self.train_path)
        splits = [self._load_split(p) for p in
                  (self.test_path, self.valid_path, self.train_path)]
        self.original_data = np.concatenate([d for d, _ in splits], axis=0)
        self.original_labels = np.concatenate([lab for _, lab in splits],
                                              axis=0)
        self.class_lengths = [len(lab) for _, lab in splits]
        super().load_data()
