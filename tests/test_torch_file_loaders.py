"""The port's file loaders and the YaleFaces sample against the JAX
reference on the CPU, on files written into ``tmp_path``.

  - ``scan_class_dirs``: classes sorted, files sorted, image extensions
    only (any case), as the reference's;
  - a class in the valid split that train does not have raises
    ``ValueError`` in both packages;
  - ``decode_image`` of grayscale and RGB PNGs, at their size and resized,
    bit for bit the reference's;
  - ``yale_faces.ensure_dataset`` writes PNG trees that both packages'
    ``FullBatchFileImageLoader`` decode to the same arrays and labels;
  - a reduced YaleFaces (3 subjects x 8 + 2 images, batch 8, 2 epochs)
    from seed 1013 on the unit engine and on ``FusedTrainer`` under
    ``fused_tail`` against the reference's run on the same engine, within
    ``STEP_TOL``;
  - ``HDF5Loader`` (``class_lengths`` as a dataset and as an attribute)
    and ``FullBatchPicklesLoader`` (tuple and dict pickles, gzipped or
    not) on the same files as the reference's loaders;
  - ``MinibatchesSaver`` files read by the other package's
    ``MinibatchesLoader``, both ways: the same records, numpy arrays only.
"""

import gzip
import os
import pickle

import numpy as np
import pytest

from test_torch_kanji import assert_same_run, train_both
from test_torch_layers import sample_config
from test_torch_planner import knobs

YALE = {"loader__n_subjects": 3, "loader__n_train_per_subject": 8,
        "loader__n_valid_per_subject": 2, "loader__minibatch_size": 8,
        "decision__max_epochs": 2}


def _png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def test_scan_class_dirs_orders_as_the_reference(tmp_path):
    from znicz_torch.loader.image import scan_class_dirs as t_scan
    from znicz_tpu.loader.image import scan_class_dirs as j_scan

    img = np.zeros((4, 4), np.uint8)
    for rel in ("b/2.png", "b/10.PNG", "a/z.jpg", "a/notes.txt",
                "c_not_a_class.png", "_x/1.bmp"):
        path = tmp_path / rel
        if rel.endswith(".txt"):
            path.write_text("no image")
        elif rel.endswith((".png", ".PNG")):
            _png(str(path), img)
        else:
            os.makedirs(path.parent, exist_ok=True)
            path.write_bytes(b"")
    got = t_scan(str(tmp_path))
    assert got == j_scan(str(tmp_path))
    paths, labels, names = got
    assert names == ["_x", "a", "b"]
    assert [os.path.relpath(p, tmp_path) for p in paths] == [
        "_x/1.bmp", "a/z.jpg", "b/10.PNG", "b/2.png"]
    assert labels == [0, 1, 2, 2]


def _loaders(pkg, base, **kw):
    import importlib

    image = importlib.import_module(f"{pkg}.loader.image")
    return image.FullBatchFileImageLoader(
        name="loader", train_path=str(base / "train"),
        valid_path=str(base / "valid"), minibatch_size=4, **kw)


def _init(pkg, loader):
    loader.initialize(device=None if pkg == "znicz_tpu" else "cpu")
    return loader


def _arrays(pkg, loader):
    if pkg == "znicz_tpu":
        return (np.asarray(loader.original_data.mem),
                np.asarray(loader.original_labels.mem))
    return loader.original_data, loader.original_labels


def test_an_unknown_class_in_another_split_raises(tmp_path):
    img = np.full((4, 4), 7, np.uint8)
    for rel in ("train/a/0.png", "train/b/0.png", "valid/a/0.png",
                "valid/zz/0.png"):
        _png(str(tmp_path / rel), img)
    for pkg in ("znicz_tpu", "znicz_torch"):
        with pytest.raises(ValueError, match=r"\['zz'\].*absent from "
                                             r"train_path"):
            _init(pkg, _loaders(pkg, tmp_path, target_shape=(4, 4)))


@pytest.mark.parametrize("grayscale", [True, False], ids=["gray", "rgb"])
@pytest.mark.parametrize("target", [(6, 5), (4, 3), (9, 8)])
def test_decode_is_the_references_bit_for_bit(grayscale, target, tmp_path):
    from znicz_torch.loader.image import decode_image as t_decode
    from znicz_tpu.loader.image import decode_image as j_decode

    rng = np.random.default_rng(11)
    paths = []
    for shape in ((6, 5), (6, 5, 3)):
        path = str(tmp_path / f"img{len(shape)}.png")
        _png(path, rng.integers(0, 256, size=shape).astype(np.uint8))
        paths.append(path)
    for path in paths:
        got = t_decode(path, target, grayscale)
        want = j_decode(path, target, grayscale)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == tuple(target) + (() if grayscale else (3,))
        np.testing.assert_array_equal(got, want)
        assert 0.0 <= got.min() and got.max() <= 1.0


def test_yale_pngs_decode_alike_in_both_packages(tmp_path):
    from znicz_torch.core import prng as tprng
    from znicz_torch.samples import yale_faces as tyale
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.samples import yale_faces as jyale

    with sample_config("yale_faces", **YALE):
        jprng.reset(1013)
        jbase = jyale.ensure_dataset(str(tmp_path / "ref"))
        tprng.reset(1013)
        tbase = tyale.ensure_dataset(str(tmp_path / "port"))
        assert tyale.ensure_dataset(tbase) == tbase     # kept, not redrawn
    names = sorted(os.listdir(tmp_path / "port" / "train"))
    assert names == [f"subject_{i:02d}" for i in range(3)]
    assert len(os.listdir(tmp_path / "port" / "valid" / names[0])) == 2
    got = {}
    for pkg, base in (("znicz_tpu", jbase), ("znicz_torch", tbase)):
        for where in ("ref", "port"):
            ldr = _init(pkg, _loaders(pkg, tmp_path / where,
                                      target_shape=(32, 32)))
            got[pkg, where] = _arrays(pkg, ldr) + (list(ldr.class_lengths),)
    want = got["znicz_tpu", "ref"]
    assert want[0].shape == (30, 32, 32, 3) and want[2] == [0, 6, 24]
    for key, (data, labels, lengths) in got.items():
        np.testing.assert_array_equal(data, want[0], err_msg=str(key))
        np.testing.assert_array_equal(labels, want[1], err_msg=str(key))
        assert lengths == want[2]


@pytest.mark.parametrize("fused", [False, True], ids=["units", "fused_tail"])
def test_reduced_yale_faces_matches_the_reference(fused, tmp_path):
    with sample_config("yale_faces", **YALE), knobs(fused_tail=fused):
        jwf, j_losses, twf = train_both(
            "yale_faces", tmp_path, fused,
            {"data_dir": str(tmp_path / "faces")})
    assert twf.loader.original_data.shape == (30, 32, 32, 3)
    assert twf.loader.class_names == ["subject_00", "subject_01",
                                      "subject_02"]
    assert_same_run(jwf, j_losses, twf, 6, ("loss", "err_pct"))


def _h5(path, data, labels, lengths, as_attr):
    import h5py

    with h5py.File(path, "w") as f:
        f["data"] = data
        f["labels"] = labels
        if as_attr:
            f.attrs["class_lengths"] = lengths
        else:
            f["class_lengths"] = np.asarray(lengths, np.int64)


def _run_loader(pkg, loader, n_runs=6):
    """(data, labels, class_lengths, served index rows) of ``loader``
    after ``prng.reset(1013)`` and ``n_runs`` minibatches."""
    import importlib

    importlib.import_module(f"{pkg}.core.prng").reset(1013)
    _init(pkg, loader)
    rows = []
    for _ in range(n_runs):
        loader.run()
        idx = getattr(loader.minibatch_indices, "mem",
                      loader.minibatch_indices)
        rows.append(np.array(idx))
    return _arrays(pkg, loader) + (list(loader.class_lengths), rows)


def _same_loads(make):
    want = _run_loader("znicz_tpu", make("znicz_tpu"))
    got = _run_loader("znicz_torch", make("znicz_torch"))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("as_attr", [True, False], ids=["attr", "dataset"])
def test_hdf5_loader_reads_as_the_reference(as_attr, tmp_path):
    import importlib

    rng = np.random.default_rng(2)
    data = rng.normal(size=(20, 3, 2)).astype(np.float64)
    labels = rng.integers(0, 4, size=20)
    path = str(tmp_path / "set.h5")
    _h5(path, data, labels, [2, 6, 12], as_attr)

    def make(pkg):
        mod = importlib.import_module(f"{pkg}.loader.hdf5")
        return mod.HDF5Loader(name="loader", file_path=path,
                              minibatch_size=4)

    got = _same_loads(make)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert got[2] == [2, 6, 12]


@pytest.mark.parametrize("form", ["tuple", "dict_gz"])
def test_pickles_loader_reads_as_the_reference(form, tmp_path):
    import importlib

    from znicz_torch.loader.pickles import load_pickle

    rng = np.random.default_rng(4)
    paths = {}
    for split, n in (("valid", 5), ("train", 11)):
        data = rng.normal(size=(n, 2, 3))
        labels = rng.integers(0, 3, size=n).tolist()
        obj = (data, labels) if form == "tuple" else \
            {"data": data, "labels": labels}
        path = str(tmp_path / (f"{split}.pickle" + (".gz" if "gz" in form
                                                    else "")))
        with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
            pickle.dump(obj, f)
        paths[split] = path
    d, lab = load_pickle(paths["train"])
    assert d.dtype == np.float32 and lab.dtype == np.int32

    def make(pkg):
        mod = importlib.import_module(f"{pkg}.loader.pickles")
        return mod.FullBatchPicklesLoader(
            name="loader", valid_pickle=paths["valid"],
            train_pickle=paths["train"], minibatch_size=4)

    got = _same_loads(make)
    assert got[2] == [0, 5, 11]


def _record(pkg, path, n_runs):
    """Run a seeded 14-row loader of ``pkg`` ``n_runs`` times with a
    ``MinibatchesSaver`` linked to it writing ``path``; returns the
    records written, in order."""
    import importlib

    prng = importlib.import_module(f"{pkg}.core.prng")
    fullbatch = importlib.import_module(f"{pkg}.loader.fullbatch")
    saver = importlib.import_module(f"{pkg}.loader.saver")
    prng.reset(1013)
    rng = np.random.default_rng(9)
    data = rng.normal(size=(14, 3)).astype(np.float32)
    labels = (np.arange(14) % 3).astype(np.int32)
    ldr = fullbatch.FullBatchLoader(name="loader", minibatch_size=4)
    ldr.class_lengths = [0, 4, 10]
    if pkg == "znicz_tpu":
        ldr.original_data.mem, ldr.original_labels.mem = data, labels
    else:
        ldr.original_data, ldr.original_labels = data, labels
    _init(pkg, ldr)
    unit = saver.MinibatchesSaver(name="saver", file_path=path)
    unit.link_attrs(ldr, "minibatch_data", "minibatch_labels",
                    "minibatch_class", "minibatch_size")
    unit.initialize(device=None)
    out = []
    for _ in range(n_runs):
        ldr.run()
        unit.run()
        idx = getattr(ldr.minibatch_indices, "mem", ldr.minibatch_indices)
        out.append((data[np.asarray(idx)], labels[np.asarray(idx)],
                    ldr.minibatch_class, ldr.minibatch_size))
    unit.stop()
    return out


@pytest.mark.parametrize("writer,reader", [("znicz_torch", "znicz_tpu"),
                                           ("znicz_tpu", "znicz_torch")])
def test_saver_files_cross_the_packages(writer, reader, tmp_path):
    import importlib

    path = str(tmp_path / "minibatches.pgz")
    served = _record(writer, path, 5)
    with gzip.open(path, "rb") as f:
        first = pickle.load(f)
    assert isinstance(first["data"], np.ndarray)
    assert first["labels"].dtype == np.int32
    saver = importlib.import_module(f"{reader}.loader.saver")
    ldr = saver.MinibatchesLoader(name="loader", file_path=path)
    ldr.initialize(device=None if reader == "znicz_tpu" else "cpu")
    assert list(ldr.class_lengths) == [0, 8, 10]
    for epoch in range(2):
        for i, (data, labels, klass, size) in enumerate(served):
            ldr.run()
            np.testing.assert_array_equal(ldr.minibatch_data.map_read(),
                                          data)
            np.testing.assert_array_equal(ldr.minibatch_labels.map_read(),
                                          labels)
            assert (ldr.minibatch_class, ldr.minibatch_size) == (klass,
                                                                size)
            assert ldr.last_minibatch == (i == len(served) - 1)
            assert ldr.epoch_number == epoch
    assert [r[2] for r in served] == [1, 2, 2, 2, 1]
