"""The reference keywords of the loaders and the snapshotter that the port
now reads or refuses, against the reference on the CPU:

  - every normalizer of ``znicz_torch/normalization.py`` (the port's
    copy): ``fit``, ``apply_inplace``, ``state`` and ``restore`` give the
    reference's bits on the same array;
  - ``FullBatchLoader(normalizer=...)`` fits on the TRAIN rows alone and
    normalises every row before the device copy (after
    ``tests/test_loader.py:91``, ``:104``);
  - ``Loader(balance_classes=True)``: each epoch's TRAIN order equals
    the reference's index for index (after ``tests/test_loader.py:135``);
  - a normalizer's state round-trips through a port snapshot, and a
    reference snapshot's restores into the port;
  - ``Loader(native_shuffle=...)``: None and False shuffle with numpy,
    True with the host runtime, each in the reference's order;
  - ``Snapshotter`` reads the reference's ``compression``, ``format``
    and ``sharded`` keywords: their paths and flags, defaults and others.
"""

import numpy as np
import pytest

NORMALIZERS = ("none", "linear", "mean_disp", "exp", "pointwise")


def _data(seed=3, n=40, shape=(3, 4)):
    """Rows of features at very different scales, one feature constant
    (a zero dispersion)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + shape) * np.geomspace(0.01, 300.0, shape[-1])
    x[:, 0, 1] = 2.5
    return x.astype(np.float32)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", NORMALIZERS)
def test_normalizer_matches_reference_bit_for_bit(name):
    from znicz_torch import normalization as tnorm
    from znicz_tpu import normalization as jnorm

    data = _data()
    tn, jn = tnorm.make(name), jnorm.make(name)
    assert type(tn).__name__ == type(jn).__name__
    tn.fit(data[10:])
    jn.fit(data[10:])
    _same(tn.state(), jn.state())
    got, want = data.copy(), data.copy()
    tn.apply_inplace(got)
    jn.apply_inplace(want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    # a restored normalizer applies the same transform
    back = tnorm.make(name)
    back.restore(jn.state())
    again = data.copy()
    back.apply_inplace(again)
    np.testing.assert_array_equal(again, want)


def _port_loader(data, labels, lengths, **kw):
    from znicz_torch.loader.fullbatch import FullBatchLoader

    ld = FullBatchLoader(name="ld", minibatch_size=4, **kw)
    ld.original_data = data
    ld.original_labels = labels
    ld.class_lengths = list(lengths)
    ld.initialize(device="cpu")
    return ld


def _jax_loader(data, labels, lengths, **kw):
    from znicz_tpu.loader.fullbatch import FullBatchLoader

    ld = FullBatchLoader(name="ld", minibatch_size=4, **kw)
    ld.original_data.mem = data
    ld.original_labels.mem = labels
    ld.class_lengths = list(lengths)
    ld.initialize(device=None)
    return ld


@pytest.mark.parametrize("name", ["linear", "mean_disp", "pointwise"])
def test_loader_fits_on_train_rows_only(name):
    """The normalizer sees the TRAIN rows alone (the reference's
    ``data[train_start:]``) and transforms every row in place, before the
    device copy; the port's rows equal the reference's."""
    from znicz_torch.normalization import make as tmake
    from znicz_tpu.normalization import make as jmake

    lengths = (4, 6, 10)
    data = np.arange(20 * 3, dtype=np.float32).reshape(20, 3) * \
        np.float32([1.0, -2.0, 0.5])
    labels = np.arange(20, dtype=np.int32) % 5
    tl = _port_loader(data.copy(), labels, lengths, normalizer=tmake(name))
    jl = _jax_loader(data.copy(), labels, lengths, normalizer=jmake(name))
    fitted = tmake(name)
    fitted.fit(data[10:].copy())
    _same(tl.normalizer.state(), fitted.state())
    _same(tl.normalizer.state(), jl.normalizer.state())
    np.testing.assert_array_equal(tl.original_data,
                                  np.asarray(jl.original_data.mem))
    np.testing.assert_array_equal(tl.data.numpy(), tl.original_data)
    if name == "linear":                # train rows span [-1, 1] exactly
        assert tl.normalizer.vmin == -116.0 and tl.normalizer.vmax == 57.0
    np.testing.assert_array_equal(tl.train_labels(), labels)


class _Imbalanced:
    """The reference test's population: 20 valid rows, 200 train rows of
    which 180 are class 1 and 20 class 0."""

    @staticmethod
    def arrays():
        n_valid, n_train = 20, 200
        labels = np.zeros(n_valid + n_train, np.int32)
        labels[n_valid:] = (np.arange(n_train) < 180).astype(np.int32)
        data = np.random.default_rng(0).normal(
            size=(n_valid + n_train, 4)).astype(np.float32)
        return data, labels, (0, n_valid, n_train)


def _epoch_orders(ld, epochs, indices):
    from znicz_torch.loader.base import TRAIN

    out = []
    for _ in range(epochs):
        got = []
        while True:
            ld.run()
            if ld.minibatch_class == TRAIN:
                got.append(np.array(indices(ld))[:ld.minibatch_size].copy())
            if ld.last_minibatch:
                break
        out.append(np.concatenate(got))
    return out


@pytest.mark.parametrize("shuffle", [True, False])
def test_balance_classes_orders_match_reference(shuffle):
    """Each epoch's TRAIN indices equal the reference's, index for index,
    with and without the shuffle before the balancing; every label gets
    an equal share and the valid segment is untouched."""
    from znicz_torch.core import prng as tprng
    from znicz_tpu.core import prng as jprng

    data, labels, lengths = _Imbalanced.arrays()
    jprng.reset(1013)
    tprng.reset(1013)
    jl = _jax_loader(data, labels, lengths, balance_classes=True,
                     shuffle=shuffle)
    tl = _port_loader(data, labels, lengths, balance_classes=True,
                      shuffle=shuffle)
    want = _epoch_orders(jl, 4, lambda ld: ld.minibatch_indices.mem)
    got = _epoch_orders(tl, 4, lambda ld: ld.minibatch_indices)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.bincount(labels[g], minlength=2).tolist() == [100, 100]
    assert not np.array_equal(got[0], got[1])
    np.testing.assert_array_equal(tl._shuffled_indices[:20], np.arange(20))


def test_balance_needs_labels_and_is_off_by_default():
    from znicz_torch.core import prng as tprng
    from znicz_torch.loader.base import Loader

    data, labels, lengths = _Imbalanced.arrays()
    tprng.reset(1013)
    plain = _port_loader(data, labels, lengths)
    assert plain.balance_classes is False
    order = plain._shuffled_indices[20:]
    assert sorted(order.tolist()) == list(range(20, 220))
    assert Loader.train_labels(plain) is None


def _norm_workflow(tmp_path, normalizer):
    """A one-layer port workflow whose loader normalises its data."""
    from znicz_torch.core.config import root
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.standard_workflow import StandardWorkflow

    root.common.dirs.snapshots = str(tmp_path)
    ld = FullBatchLoader(minibatch_size=5, normalizer=normalizer)
    ld.original_data = _data(n=20).reshape(20, -1)
    ld.original_labels = np.arange(20, dtype=np.int32) % 3
    ld.class_lengths = [0, 5, 15]
    return StandardWorkflow(
        [{"type": "softmax", "->": {"output_sample_shape": 3}}],
        device="cpu", loader=ld)


def test_normalizer_round_trips_through_a_port_snapshot(tmp_path):
    from znicz_torch.normalization import MeanDispNormalizer
    from znicz_torch.snapshotter import Snapshotter, collect, restore

    wf = _norm_workflow(tmp_path, MeanDispNormalizer())
    state = wf.loader.normalizer.state()
    path = wf.snapshotter.save("norm")
    snap = Snapshotter.load(path)
    _same(snap["loader"]["normalizer"], state)
    _same(collect(wf)["loader"]["normalizer"], state)
    fresh = _norm_workflow(tmp_path, MeanDispNormalizer())
    fresh.loader.normalizer.mean[...] = 0.0
    restore(fresh, snap)
    _same(fresh.loader.normalizer.state(), state)


def test_reference_normalizer_snapshot_restores_in_the_port(tmp_path):
    """A snapshot the reference writes (its ``collect_meta`` puts the
    loader's normalizer state in it) restores the port's normalizer."""
    from znicz_torch.normalization import LinearNormalizer as TLinear
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_tpu.loader.fullbatch import FullBatchLoader
    from znicz_tpu.normalization import LinearNormalizer as JLinear
    from znicz_tpu.snapshotter import collect_meta, write_host_pickle

    data = _data(n=20).reshape(20, -1)
    jl = FullBatchLoader(name="loader", minibatch_size=5,
                         normalizer=JLinear(interval=(-2.0, 3.0)))
    jl.original_data.mem = data.copy()
    jl.original_labels.mem = np.arange(20, dtype=np.int32) % 3
    jl.class_lengths = [0, 5, 15]
    jl.initialize(device=None)
    path = str(tmp_path / "ref.pickle.gz")
    write_host_pickle(path, collect_meta([jl]))
    wf = _norm_workflow(tmp_path, TLinear())
    assert wf.loader.normalizer.interval == (-1.0, 1.0)
    restore(wf, Snapshotter.load(path))
    _same(wf.loader.normalizer.state(), jl.normalizer.state())
    assert wf.loader.normalizer.interval == (-2.0, 3.0)


@pytest.mark.parametrize("value,native", [
    (None, False), (False, False), (True, True)])
def test_native_shuffle_is_refused(value, native):
    """``native_shuffle`` is ported: None and False shuffle with numpy's
    ``loader`` stream, True with the host runtime's xorshift128+, each
    giving the reference's order."""
    from znicz_torch.core import prng as tprng
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.loader.fullbatch import FullBatchLoader as JLoader

    data = _data(n=20).reshape(20, -1)
    tprng.reset(1013)
    tl = FullBatchLoader(minibatch_size=5, native_shuffle=value)
    tl.original_data, tl.class_lengths = data.copy(), [0, 5, 15]
    tl.initialize("cpu")
    jprng.reset(1013)
    jl = JLoader(name="loader", minibatch_size=5, native_shuffle=value)
    jl.original_data.mem, jl.class_lengths = data.copy(), [0, 5, 15]
    jl.initialize(device=None)
    assert tl.shuffle is True and tl._use_native_shuffle() is native
    for _ in range(8):                          # two epochs
        tl.run()
        jl.run()
        np.testing.assert_array_equal(tl.minibatch_indices,
                                      jl.minibatch_indices.mem)
    assert (tl._native_rng is not None) is native


@pytest.mark.parametrize("key,value,refused", [
    ("compression", "gz", False), ("compression", "none", True),
    ("compression", "", True), ("format", "pickle", False),
    ("format", "orbax", True), ("sharded", False, False),
    ("sharded", True, True)])
def test_snapshotter_keywords_are_refused(key, value, refused, tmp_path):
    """Each keyword, at the reference's default or another value
    (``refused`` names the values an earlier slice refused), is read as
    the reference reads it: "gz" writes ``.pickle.gz`` and any other
    compression ``.pickle``; "orbax" a ``.orbax`` directory; ``sharded``
    is kept.  The reference's snapshotter gives the same paths."""
    from znicz_torch.snapshotter import Snapshotter
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter

    snap = Snapshotter(directory=str(tmp_path), **{key: value})
    jsnap = JSnapshotter(directory=str(tmp_path), **{key: value})
    want = {("compression", "gz"): "wf_best.pickle.gz",
            ("compression", "none"): "wf_best.pickle",
            ("compression", ""): "wf_best.pickle",
            ("format", "orbax"): "wf_best.orbax"}.get((key, value),
                                                       "wf_best.pickle.gz")
    assert snap.snapshot_path("best").endswith(want)
    assert snap.snapshot_path("best") == jsnap.snapshot_path("best")
    assert getattr(snap, key) == getattr(jsnap, key) == value
    assert (value != {"compression": "gz", "format": "pickle",
                      "sharded": False}[key]) == refused
