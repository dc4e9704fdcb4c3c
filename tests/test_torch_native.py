"""The port's host runtime (``znicz_torch/native.py`` over its own copy of
the C++ source, ``znicz_torch/csrc/host/znicz_native.cpp``) against the
reference's ``znicz_tpu/native.py`` on the CPU.

  - the library builds from the port's copy into a directory of its own,
    named by a hash of the source and flags, and its C code is the
    reference's;
  - ``XorShift128P``'s uniform and normal fills and its shuffle are bit
    for bit the reference's native stream, at several seeds; seed 1013's
    first 16 uniforms and its shuffle of ``arange(1000)`` are pinned here
    and equal to ``chip_smoke.py``'s copy, which the card checks;
  - ``gather_f32`` and ``u8_to_f32`` (numpy) equal the reference's, both
    through its library and through its numpy path;
  - a loader under ``native_shuffle`` (the keyword, or the engine knob
    ``root.common.engine.native_shuffle``) serves the reference's index
    order over 3 epochs;
  - without a compiler the build, ``XorShift128P`` and a
    ``native_shuffle`` loader raise (the reference falls back to numpy's
    order), while the decode needs no library;
  - a compiler that fails is run once, however many streams ask for the
    library after it.
"""

import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

#: XorShift128P(1013): its first 16 uniforms in [0, 1), and its shuffle of
#: arange(1000) as int32 (first 8 entries and the sha256 of its bytes)
PINNED_UNIFORM = [
    0.8475832343101501, 0.1285988837480545, 0.14996427297592163,
    0.4142548143863678, 0.8048638105392456, 0.12118154764175415,
    0.9533067941665649, 0.3582358658313751, 0.44586315751075745,
    0.31895825266838074, 0.2598508894443512, 0.7621958255767822,
    0.7675018310546875, 0.9624818563461304, 0.45829910039901733,
    0.37678441405296326]
PINNED_SHUFFLE_HEAD = [134, 720, 975, 392, 259, 467, 339, 25]
PINNED_SHUFFLE_SHA256 = \
    "a19974db28f8eb1626ca826d07f4ebae770872d575a51a9374b22af9a788e582"


def _code(path):
    """The C++ source from its first #include on (the header comments
    differ)."""
    text = pathlib.Path(path).read_text()
    return text[text.index("#include"):]


def test_the_library_builds_from_the_ports_own_copy(tmp_path, monkeypatch):
    from znicz_torch import native

    assert native.SOURCE == REPO / "znicz_torch" / "csrc" / "host" / \
        "znicz_native.cpp"
    assert _code(native.SOURCE) == _code(REPO / "native" / "znicz_native.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    path = native.build()
    assert path.parent == tmp_path / "host" and path.exists()
    assert path.name.startswith("libznicz_native-") and \
        path.suffix == ".so"
    assert native.build() == path                 # built once
    lib = native.lib()
    assert lib.znicz_native_abi() == native.ABI


@pytest.mark.parametrize("seed", [0, 1013, 2 ** 63 - 1])
def test_xorshift_matches_the_reference_bit_for_bit(seed):
    from znicz_torch import native as tn
    from znicz_tpu import native as jn

    assert jn.available()
    t, j = tn.XorShift128P(seed), jn.XorShift128P(seed)
    np.testing.assert_array_equal(t.state, j.state)
    for n in (16, 7, 1001):                       # odd n: a half pair
        a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
        t.fill_uniform(a, -2.0, 3.0)
        j.fill_uniform(b, -2.0, 3.0)
        np.testing.assert_array_equal(a, b)
        t.fill_normal(a, 0.5)
        j.fill_normal(b, 0.5)
        np.testing.assert_array_equal(a, b)
        p, q = np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32)
        t.shuffle(p)
        j.shuffle(q)
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(t.state, j.state)


def test_seed_1013_gives_the_pinned_draws():
    from znicz_torch import native

    u = np.zeros(16, np.float32)
    native.XorShift128P(1013).fill_uniform(u, 0.0, 1.0)
    assert [float(v) for v in u] == PINNED_UNIFORM
    p = np.arange(1000, dtype=np.int32)
    native.XorShift128P(1013).shuffle(p)
    assert p[:8].tolist() == PINNED_SHUFFLE_HEAD
    assert hashlib.sha256(p.tobytes()).hexdigest() == PINNED_SHUFFLE_SHA256
    assert sorted(p.tolist()) == list(range(1000))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.NATIVE_PINS == {
        "seed": 1013, "uniform": PINNED_UNIFORM,
        "shuffle_head": PINNED_SHUFFLE_HEAD,
        "shuffle_sha256": PINNED_SHUFFLE_SHA256}


@pytest.mark.parametrize("library", [True, False], ids=["library", "numpy"])
def test_gather_and_decode_match_the_reference(library, monkeypatch):
    """The port's numpy bodies against the reference's C loops
    (``library``) and against its numpy fallback."""
    from znicz_torch import native as tn
    from znicz_tpu import native as jn

    assert jn.available()
    if not library:
        monkeypatch.setattr(jn, "available", lambda: False)
    rng = np.random.default_rng(5)
    src = rng.normal(size=(10, 3, 4)).astype(np.float32)
    idx = np.array([3, 1, 9, 3, 0], np.int32)
    got = tn.gather_f32(src, idx)
    np.testing.assert_array_equal(got, jn.gather_f32(src, idx))
    np.testing.assert_array_equal(got, src[idx])
    dst = np.empty((5, 3, 4), np.float32)
    assert tn.gather_f32(src, idx, dst) is dst
    with pytest.raises(IndexError):
        tn.gather_f32(src, np.array([10], np.int32))
    u8 = rng.integers(0, 256, size=(6, 5, 3)).astype(np.uint8)
    for scale, shift in ((1.0 / 255.0, 0.0), (0.5, -1.0)):
        got = tn.u8_to_f32(u8, scale, shift)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jn.u8_to_f32(u8, scale, shift))


def _loader_order(pkg, native_shuffle, epochs=3):
    """The index rows a seeded full-batch loader of package ``pkg`` serves
    over ``epochs`` epochs (40 rows, 10 valid + 30 train, batch 7)."""
    import importlib

    prng = importlib.import_module(f"{pkg}.core.prng")
    fullbatch = importlib.import_module(f"{pkg}.loader.fullbatch")
    prng.reset(1013)
    data = np.arange(120, dtype=np.float32).reshape(40, 3)
    ldr = fullbatch.FullBatchLoader(minibatch_size=7,
                                    native_shuffle=native_shuffle)
    ldr.class_lengths = [0, 10, 30]
    if pkg == "znicz_tpu":
        ldr.original_data.mem = data
        ldr.initialize(device=None)
    else:
        ldr.original_data = data
        ldr.initialize("cpu")
    rows = []
    while not (ldr.last_minibatch and ldr.epoch_number == epochs - 1):
        ldr.run()
        idx = getattr(ldr.minibatch_indices, "mem", ldr.minibatch_indices)
        rows.append(np.array(idx[:ldr.minibatch_size]))
    return np.concatenate(rows)


@pytest.mark.parametrize("how", ["keyword", "engine_knob"])
def test_native_shuffle_gives_the_reference_order(how):
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    keyword = True if how == "keyword" else None
    try:
        if how == "engine_knob":
            for tree in (troot, jroot):
                tree.common.engine.native_shuffle = True
        got = _loader_order("znicz_torch", keyword)
        want = _loader_order("znicz_tpu", keyword)
    finally:
        for tree in (troot, jroot):
            tree.common.engine.native_shuffle = False
    assert len(got) == 3 * 40
    np.testing.assert_array_equal(got, want)
    train = got.reshape(3, 40)[:, 10:]
    assert not np.array_equal(train[0], train[1])      # reshuffled
    assert all(sorted(t) == list(range(10, 40)) for t in train)
    numpy_order = _loader_order("znicz_torch", False)
    assert not np.array_equal(numpy_order, got)


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    from znicz_torch import native
    from znicz_torch.core import prng
    from znicz_torch.loader.fullbatch import FullBatchLoader

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="no-such-compiler-g"):
        native.build()
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.lib()
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.XorShift128P(1013)
    prng.reset(1013)
    ldr = FullBatchLoader(minibatch_size=4, native_shuffle=True)
    ldr.original_data = np.zeros((12, 2), np.float32)
    with pytest.raises(RuntimeError, match="cannot be built"):
        ldr.initialize("cpu")
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        native.u8_to_f32(u8), u8.astype(np.float32) * np.float32(1 / 255))
    assert not list(tmp_path.rglob("*.so"))


def test_a_failing_compiler_runs_once(tmp_path, monkeypatch):
    from znicz_torch import native
    from znicz_torch.core import prng
    from znicz_torch.loader.fullbatch import FullBatchLoader

    runs = tmp_path / "runs"
    cxx = tmp_path / "failing-g++"
    cxx.write_text(f"#!/bin/sh\necho run >> {runs}\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "CXX", str(cxx))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="failing-g"):
            native.XorShift128P(1013)
    prng.reset(1013)
    ldr = FullBatchLoader(minibatch_size=4, native_shuffle=True)
    ldr.original_data = np.zeros((12, 2), np.float32)
    with pytest.raises(RuntimeError, match="failing-g"):
        ldr.initialize("cpu")
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for _ in range(3):
        native.u8_to_f32(u8)
    assert runs.read_text().splitlines() == ["run"]
    assert not list(tmp_path.rglob("*.so"))
