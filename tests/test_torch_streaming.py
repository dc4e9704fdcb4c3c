"""The streaming data path (``loader/streaming.py``, ``loader/ingest.py``
and the trainer's staged segments) against the JAX reference on the CPU.

  - staged float32 against the resident ``FullBatchLoader``, and staged
    uint8 against resident uint8: the same bits, every segment staged
    (``stats["staged_segments"]``), the reference's staged runs within
    ``STEP_TOL``;
  - the uint8 decode in the step against the host's decode of the same
    rows, on ``FusedTrainer`` and on the unit engine: the same bits;
  - ``ImageFileSource`` over written PNGs: the rows, a staged run against
    the reference's, pooled against serial decode bit for bit with the
    prefetch hitting;
  - the ``DecodePool`` bounds, the ``DeviceStager`` contract;
  - the knobs of the path set in both packages: ``stream_budget_mb``,
    ``decode_workers``, ``prefetch_segments``, ``async_staging``,
    ``staging_donate``, each with the counter that shows it acted;
  - the two refusals: a normalizer, an MSE run without targets.
"""

import os
import time

import numpy as np
import pytest
import torch

from test_torch_layers import jax_params, port_sample, sample_config
from test_torch_segments import engine
from test_torch_train import STEP_TOL

#: tests/test_streaming.py's MNIST: 290 train rows, so the tail is short
STREAM = {"loader__n_train": 290, "loader__n_valid": 60, "loader__n_test": 0,
          "loader__minibatch_size": 60, "decision__max_epochs": 2}


def _digits(pkg, u8):
    """The procedural digits the MNIST loader draws, flattened; uint8 as
    the reference's streaming tests round them."""
    import importlib

    cfg = importlib.import_module(f"{pkg}.core.config").root.mnist.loader
    datasets = importlib.import_module(f"{pkg}.datasets")
    total = int(cfg.n_train) + int(cfg.n_valid) + int(cfg.n_test)
    data, labels = datasets.load_or_generate(None, datasets.digits, total)
    data = data.reshape(total, -1)
    if u8:
        data = np.clip(np.round(data * 255.0), 0, 255).astype(np.uint8)
    return data, labels


def _port_loader(u8, budget, predecoded=False):
    """A port MNIST loader class: streaming (``budget`` bytes resident,
    None: the engine's knob) or, with ``predecoded``, the resident float32
    loader over the host's decode of the uint8 rows."""
    from znicz_torch.core.config import root
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.loader.streaming import HostArraySource, StreamingLoader

    class Predecoded(FullBatchLoader):
        def load_data(self):
            cfg = root.mnist.loader
            data, labels = _digits("znicz_torch", True)
            self.original_data = (data.astype(np.float32)
                                  * np.float32(1.0 / 255.0) + np.float32(0))
            self.original_labels = labels
            self.class_lengths = [int(cfg.n_test), int(cfg.n_valid),
                                  int(cfg.n_train)]
            super().load_data()

    class Streaming(StreamingLoader):
        def __init__(self, workflow=None, name="loader", **kwargs):
            cfg = root.mnist.loader
            data, labels = _digits("znicz_torch", u8)
            super().__init__(
                workflow=workflow, name=name,
                source=HostArraySource(data, labels),
                class_lengths=[int(cfg.n_test), int(cfg.n_valid),
                               int(cfg.n_train)],
                scale=1.0 / 255.0 if u8 else 1.0, shift=0.0,
                device_budget_bytes=budget, **kwargs)

    return Predecoded if predecoded else Streaming


def port_mnist(tmp_path, loader_cls=None, fused=True, **knobs):
    """(workflow, trainer or None) of a seeded MNIST run with the port's
    loader class swapped for ``loader_cls``."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples import mnist

    orig = mnist.MnistLoader
    with sample_config("mnist", **STREAM), engine(**knobs):
        if loader_cls is not None:
            mnist.MnistLoader = loader_cls
        try:
            wf = port_sample("mnist", tmp_path)
        finally:
            mnist.MnistLoader = orig
        if not fused:
            wf.run()
            return wf, None
        trainer = FusedTrainer(wf)
        trainer.run()
    return wf, trainer


def jax_mnist(tmp_path, u8, budget, **knobs):
    """The reference's staged or resident streaming MNIST run, its
    workflow (tests/test_streaming.py's loader)."""
    from test_streaming import _StreamingMnistLoader

    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.samples import mnist

    jroot.common.dirs.snapshots = str(tmp_path)
    _StreamingMnistLoader.u8, _StreamingMnistLoader.budget = u8, budget
    orig = mnist.MnistLoader
    with sample_config("mnist", **STREAM), engine(**knobs):
        prng.reset(1013)
        mnist.MnistLoader = _StreamingMnistLoader
        try:
            wf = mnist.MnistWorkflow()
        finally:
            mnist.MnistLoader = orig
        wf.initialize(device=None)
        trainer = JTrainer(wf)
        if budget is not None:
            assert trainer.staging == (budget == 0)
        trainer.run()
    return wf


def weights(wf):
    return {f.name: {k: p.detach().clone() for k, p in
                     (("weights", f.weights), ("bias", f.bias))}
            for f in wf.forwards}


def assert_same_run(a, b):
    assert a.decision.train_losses == b.decision.train_losses
    wa, wb = weights(a), weights(b)
    for name in wa:
        for k in wa[name]:
            assert torch.equal(wa[name][k], wb[name][k]), f"{name}.{k}"


def assert_like_reference(twf, jwf):
    np.testing.assert_allclose(twf.decision.epoch_metrics[2]["loss"],
                               jwf.decision.epoch_metrics[2]["loss"],
                               **STEP_TOL)
    got = {f.name: f.weights.detach().numpy() for f in twf.forwards}
    for name, leaves in jax_params(jwf).items():
        np.testing.assert_allclose(got[name], leaves["weights"],
                                   err_msg=name, **STEP_TOL)


def test_staged_f32_matches_resident(tmp_path):
    resident, _ = port_mnist(tmp_path)
    staged, t = port_mnist(tmp_path, _port_loader(False, 0))
    assert t.staging and not staged.loader.device_resident
    assert staged.loader.data is None                # nothing resident
    # 2 epochs of: VALID, a train segment of 4, the tail
    assert t.stats["staged_segments"] == 6
    assert t.stager_stats["stage_hits"] > 0
    assert_same_run(resident, staged)
    assert_like_reference(staged, jax_mnist(tmp_path, False, 0))


def test_staged_u8_matches_resident_u8(tmp_path):
    resident, tr = port_mnist(tmp_path, _port_loader(True, 1 << 30))
    staged, ts = port_mnist(tmp_path, _port_loader(True, 0))
    assert not tr.staging and resident.loader.data.dtype == torch.uint8
    assert ts.staging and ts.stats["staged_segments"] > 0
    assert_same_run(resident, staged)
    losses = staged.decision.train_losses
    assert losses[-1] < losses[0]                    # and it trains
    assert_like_reference(staged, jax_mnist(tmp_path, True, 0))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "units"])
def test_u8_decode_in_the_step_matches_the_host_decode(fused, tmp_path):
    """``u8 * scale + shift`` on the device (the step's decode, or the
    unit engine's ``fill_minibatch``) against the same float32 arithmetic
    on the host."""
    host, _ = port_mnist(tmp_path, _port_loader(True, 0, predecoded=True),
                         fused=fused)
    step, _ = port_mnist(tmp_path, _port_loader(True, 0), fused=fused)
    assert_same_run(host, step)


# -- image files ---------------------------------------------------------------


def _png_tree(tmp_path, n_per_class=8, size=(12, 12)):
    from test_streaming import _write_class_tree

    base = str(tmp_path / "imgs")
    os.makedirs(base)
    _write_class_tree(base, n_per_class=n_per_class, size=size)
    return base


def _image_runs(base, workers, knobs=None, max_epochs=2):
    """The reference's (tests/test_ingest.py's workflow) and the port's
    staged run over the same files from the same initial weights: (port
    workflow, trainer, reference workflow)."""
    from test_ingest import _build_stream_wf

    from znicz_torch.core import prng as tprng
    from znicz_torch.loader.streaming import StreamingLoader
    from znicz_torch.loader.streaming import class_dir_source as t_source
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.loader.streaming import class_dir_source as j_source
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    class Net(StandardWorkflow):
        def module_name(self, i, kind):
            return f"fwd{i}"

    with engine(**(knobs or {})):
        jprng.reset(4242)
        jwf = _build_stream_wf(j_source(base, (12, 12), workers=workers),
                               max_epochs=max_epochs)
        start = jax_params(jwf)
        JTrainer(jwf).run()
        tprng.reset(4242)
        ldr = StreamingLoader(source=t_source(base, (12, 12),
                                              workers=workers),
                              minibatch_size=4, class_lengths=[0, 4, 12],
                              device_budget_bytes=0)
        twf = params_from_jax(start, Net(
            [{"type": "softmax", "->": {"output_sample_shape": (2,)},
              "<-": {"learning_rate": 0.05}}], device="cpu", loader=ldr,
            decision_config={"max_epochs": max_epochs}))
        twf.snapshotter.gate_skip.set(True)
        trainer = FusedTrainer(twf)
        trainer.run()
    np.testing.assert_allclose(twf.decision.epoch_metrics[2]["loss"],
                               jwf.decision.epoch_metrics[2]["loss"],
                               **STEP_TOL)
    np.testing.assert_allclose(twf.forwards[0].weights.detach().numpy(),
                               jax_params(jwf)["fwd0"]["weights"],
                               **STEP_TOL)
    return twf, trainer, jwf


def test_image_file_source_streams(tmp_path):
    from znicz_torch.loader.streaming import class_dir_source
    from znicz_tpu.loader.streaming import class_dir_source as j_source

    base = _png_tree(tmp_path, n_per_class=4)
    src = class_dir_source(base, target_shape=(12, 12))
    assert len(src) == 8 and src.dtype == np.uint8
    rows = src.gather(np.array([0, 5], np.int32))
    assert rows.shape == (2, 12, 12, 3) and rows.dtype == np.uint8
    np.testing.assert_array_equal(
        rows, j_source(base, (12, 12)).gather(np.array([0, 5], np.int32)))
    assert src.labels.tolist() == [0] * 4 + [1] * 4


def test_image_file_run_matches_the_reference(tmp_path):
    """Every ``_image_runs`` holds the port's run to the reference's."""
    base = _png_tree(tmp_path)
    twf, t, jwf = _image_runs(base, workers=0)
    assert t.staging and t.stats["staged_segments"] > 0
    assert jwf.decision.epoch_metrics[2]["loss"] > 0


def test_measure_decode_rate(tmp_path):
    """The decode term of a file source, serial and pooled: finite and
    positive (no wall-clock bound)."""
    from znicz_torch.loader.ingest import measure_decode_rate
    from znicz_torch.loader.streaming import class_dir_source

    base = _png_tree(tmp_path, n_per_class=8, size=(32, 32))
    src = class_dir_source(base, target_shape=(24, 24), workers=0)
    for workers in (None, 2):
        rate = measure_decode_rate(src, n=16, workers=workers)
        assert np.isfinite(rate) and rate > 0


def test_prefetch_parity_and_hits(tmp_path):
    """4 decode workers against serial decode: the same bits, and past
    the first segment every staged row was prefetched."""
    base = _png_tree(tmp_path)
    serial, ts, _ = _image_runs(base, workers=0)
    pooled, tp, _ = _image_runs(base, workers=4)
    assert serial.loader.ingest_stats is None
    assert_same_run(serial, pooled)
    st = pooled.loader.ingest_stats
    assert st["prefetch_hits"] > 0 and st["decode_misses"] <= 4, st


def test_pooled_decode_matches_serial(tmp_path):
    from znicz_torch.loader.streaming import class_dir_source

    base = _png_tree(tmp_path)
    serial = class_dir_source(base, target_shape=(10, 11), workers=0)
    pooled = class_dir_source(base, target_shape=(10, 11), workers=8)
    idx = np.array([3, 0, 7, 3, 3, 12, 1, 0], np.int32)
    np.testing.assert_array_equal(serial.gather(idx), pooled.gather(idx))
    pooled.prefetch(np.array([5, 6, 2], np.int32))
    idx2 = np.array([5, 2, 6, 5, 9], np.int32)
    np.testing.assert_array_equal(serial.gather(idx2), pooled.gather(idx2))


def test_decode_pool_cache_and_bounds():
    from znicz_torch.loader.ingest import DecodePool

    calls = []

    def decode(i):
        calls.append(i)
        return np.full((2, 2), i, np.uint8)

    pool = DecodePool(decode, workers=2, max_outstanding_rows=4)
    assert pool.submit([0, 1, 2]) == 3
    assert pool.submit([2, 3, 4, 5]) == 1          # 2 cached; cap at 4
    assert pool.outstanding_rows == 4
    rows = pool.take([0, 1, 1, 1, 2, 3, 4])        # 4 was never submitted
    np.testing.assert_array_equal(rows[:, 0, 0], [0, 1, 1, 1, 2, 3, 4])
    assert pool.stats["prefetch_hits"] == 4
    assert pool.stats["decode_misses"] == 1
    assert pool.outstanding_rows == 0
    assert sorted(calls) == [0, 1, 2, 3, 4]
    pool.close()


def test_device_stager_contract():
    """Hits, an inline miss, a stale prediction kept through one miss
    and evicted at the next, the depth bound, and ``close``."""
    from znicz_torch.loader.ingest import DeviceStager

    calls = []

    def assemble(rows):
        calls.append(len(rows))
        time.sleep(0.01)
        return ("staged", DeviceStager.key_of(rows))

    st = DeviceStager(assemble, depth=2)
    a = [np.array([0, 1], np.int32)]
    b = [np.array([2, 3], np.int32), np.array([4, 5], np.int32)]
    c = [np.array([6, 7], np.int32)]
    d = [np.array([8, 9], np.int32)]
    assert st.submit(a) and st.submit(b)
    assert not st.submit(a) and not st.submit(c)
    assert st.outstanding == 2
    st.quiesce()
    assert st.take(a) == ("staged", DeviceStager.key_of(a))
    assert st.take(c) == ("staged", DeviceStager.key_of(c))
    assert st.outstanding == 1                       # b marked, not evicted
    assert st.stats()["stage_hits"] == 1 and st.stats()["stage_misses"] == 1
    assert st.take(d) == ("staged", DeviceStager.key_of(d))
    assert st.outstanding == 0
    s = st.stats()
    assert s["stage_misses"] == 2 and s["stage_evictions"] == 1
    assert len(calls) == 4
    assert st.submit(a) and st.take(a) == ("staged", DeviceStager.key_of(a))
    st.close()
    assert st.outstanding == 0


# -- the knobs -----------------------------------------------------------------


def test_stream_budget_mb_decides_the_residency(tmp_path):
    """``stream_budget_mb`` 0 stages a loader that names no budget, in
    both packages; a large one keeps it resident."""
    runs = {}
    for mb in (0, 64):
        wf, t = port_mnist(tmp_path, _port_loader(True, None),
                           stream_budget_mb=mb)
        assert t.staging == (mb == 0)
        assert (t.stats["staged_segments"] > 0) == (mb == 0)
        runs[mb] = wf
        jwf = jax_mnist(tmp_path, True, None, stream_budget_mb=mb)
        assert jwf.loader.device_resident == (mb != 0)
        assert_like_reference(wf, jwf)
    assert_same_run(runs[0], runs[64])


def test_decode_workers_sizes_the_pool(tmp_path):
    from znicz_torch.loader.ingest import default_workers
    from znicz_tpu.loader.ingest import default_workers as j_workers

    with engine(decode_workers=3):
        assert default_workers() == j_workers() == 3
    assert default_workers() >= 1
    base = _png_tree(tmp_path)
    serial, _, _ = _image_runs(base, workers=0)
    knob, _, _ = _image_runs(base, workers=None,
                             knobs={"decode_workers": 2})
    assert knob.loader.source.pool().workers == 2
    assert_same_run(serial, knob)


def test_prefetch_segments_zero_prefetches_nothing(tmp_path):
    base = _png_tree(tmp_path)
    on, _, _ = _image_runs(base, workers=2)
    off, _, jwf = _image_runs(base, workers=2,
                              knobs={"prefetch_segments": 0})
    assert on.loader.ingest_stats["prefetch_hits"] > 0
    assert off.loader.ingest_stats["prefetch_hits"] == 0
    assert off.loader.ingest_stats["rows_prefetched"] == 0
    assert jwf.loader.ingest_stats["prefetch_hits"] == 0
    assert_same_run(on, off)


@pytest.mark.parametrize("knob", ["async_staging", "staging_donate"])
def test_staging_knobs_keep_the_bits(knob, tmp_path):
    """Off, no stager (``async_staging``) or no buffer written again
    (``staging_donate``); on, the stager hits and the buffers are reused:
    the same bits either way, and the reference's run with the knob off
    within ``STEP_TOL``."""
    on, t_on = port_mnist(tmp_path, _port_loader(True, 0), **{knob: True})
    off, t_off = port_mnist(tmp_path, _port_loader(True, 0), **{knob: False})
    if knob == "async_staging":
        assert t_on.stager_stats["stage_hits"] > 0
        assert t_off.stager_stats is None
    else:
        assert t_on.staging_buffers.reused > 0
        assert t_off.staging_buffers.reused == 0
    assert_same_run(on, off)
    assert_like_reference(off, jax_mnist(tmp_path, True, 0, **{knob: False}))


# -- refusals ------------------------------------------------------------------


def test_streaming_refuses_a_normalizer():
    from znicz_torch.loader.streaming import StreamingLoader
    from znicz_torch.normalization import make

    with pytest.raises(ValueError, match="normalizer"):
        StreamingLoader(source=np.zeros((4, 3), np.float32),
                        normalizer=make("mean_disp"))


def test_streaming_mse_without_targets_raises():
    from znicz_torch.loader.streaming import StreamingLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.standard_workflow import StandardWorkflow

    data = np.random.RandomState(0).rand(32, 6).astype(np.float32)
    ldr = StreamingLoader(source=data, minibatch_size=8, scale=1.0,
                          device_budget_bytes=0)
    wf = StandardWorkflow(
        [{"type": "all2all_tanh", "->": {"output_sample_shape": 6}}],
        device="cpu", loader=ldr, loss_function="mse")
    with pytest.raises(ValueError, match="targets"):
        FusedTrainer(wf).run()
