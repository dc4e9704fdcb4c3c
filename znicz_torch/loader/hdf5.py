"""HDF5 loader (port of ``znicz_tpu/loader/hdf5.py``): an .h5/.hdf5 file
with the datasets ``data`` and, optionally, ``labels``, and the split
sizes ``class_lengths`` ([test, valid, train]) as a dataset or an
attribute (default: everything TRAIN), served as a device-resident full
batch.  ``h5py`` is imported when the file is read."""

from __future__ import annotations

import numpy as np

from znicz_torch.loader.fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    def __init__(self, workflow=None, name: str = "loader", file_path=None,
                 **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.file_path = file_path

    def load_data(self):
        if not self.file_path:
            raise ValueError(f"{self.name}: file_path required")
        import h5py

        with h5py.File(self.file_path, "r") as f:
            self.original_data = np.asarray(f["data"], np.float32)
            if "labels" in f:
                self.original_labels = np.asarray(f["labels"], np.int32)
            if "class_lengths" in f:
                self.class_lengths = [int(x) for x in f["class_lengths"][:]]
            elif "class_lengths" in f.attrs:
                self.class_lengths = [int(x)
                                      for x in f.attrs["class_lengths"]]
        super().load_data()
