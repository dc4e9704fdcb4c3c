"""Snapshots written by a background thread (``async_snapshot``, the
reference's ``Snapshotter.save_async``) on the CPU.

  - the port's async snapshot is the checkpoint its in-line save writes:
    the same parameter and velocity bits, loader order, Decision state
    and prng streams, with ``async_saves_written`` counting the files;
  - both against the reference's async and in-line snapshots of the same
    run: the arrays within ``STEP_TOL``, the loader, the epoch and the
    prng streams exact;
  - a backlog is coalesced (a queued "best" a newer one supersedes is
    dropped, interval saves are kept), and the last one is on disk when
    ``flush_async`` returns; a writer's error is raised there.
"""

import os
import threading

import numpy as np
import pytest

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_segments import engine
from test_torch_train import STEP_TOL

#: tests/test_fused.py's fresh_mnist at 3 epochs
MNIST = {"loader__n_train": 300, "loader__n_valid": 60, "loader__n_test": 0,
         "loader__minibatch_size": 60, "decision__max_epochs": 3}


def _port_snapshot(tmp_path, async_snapshot):
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import Snapshotter

    with sample_config("mnist", **MNIST), \
            engine(async_snapshot=async_snapshot):
        wf = port_sample("mnist", tmp_path)
        FusedTrainer(wf).run()
    snap = wf.snapshotter
    return Snapshotter.load(snap.destination), snap, wf


def _jax_snapshot(tmp_path, async_snapshot):
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter

    with sample_config("mnist", **MNIST), \
            engine(async_snapshot=async_snapshot):
        jwf = jax_sample("mnist", tmp_path)
        JTrainer(jwf).run()
    snap = jwf.snapshotter
    return JSnapshotter.load(snap.destination), snap


def _assert_meta_equal(a, b, same_streams=True):
    """Loader, epoch and prng streams equal.  The reference makes its
    ``fused_trainer`` stream in the trainer's constructor, the port at its
    first dropout mask: against the reference, the port's streams are a
    subset."""
    for key in ("epoch_number", "samples_served", "last_minibatch"):
        assert a["loader"][key] == b["loader"][key], key
    np.testing.assert_array_equal(a["loader"]["shuffled_indices"],
                                  b["loader"]["shuffled_indices"])
    assert a["epoch"] == b["epoch"]
    if same_streams:
        assert set(a["prng"]) == set(b["prng"])
    assert set(a["prng"]) <= set(b["prng"])
    for name in a["prng"]:
        assert repr(a["prng"][name]) == repr(b["prng"][name]), name


def _assert_arrays(a, b, exact):
    for group in ("units", "velocities"):
        assert set(a[group]) == set(b[group]), group
        for name in a[group]:
            for k, x in a[group][name].items():
                y = np.asarray(b[group][name][k], np.float32)
                if exact:
                    assert x.dtype == np.float32
                    np.testing.assert_array_equal(x, y, err_msg=f"{name}.{k}")
                else:
                    np.testing.assert_allclose(x, y, err_msg=f"{name}.{k}",
                                               **STEP_TOL)


def test_async_snapshot_equals_sync_and_the_reference(tmp_path):
    sa, snap_a, wf_a = _port_snapshot(tmp_path / "async", True)
    ss, snap_s, wf_s = _port_snapshot(tmp_path / "sync", False)
    assert snap_a.async_saves_written > 0 and snap_s.async_saves_written == 0
    assert os.path.basename(snap_a.destination) == "mnist_best.pickle.gz"
    assert wf_a.decision.train_losses == wf_s.decision.train_losses
    _assert_arrays(sa, ss, exact=True)
    _assert_meta_equal(sa, ss)
    assert sa["metric"] == ss["metric"]
    assert sa["decision"] == ss["decision"]
    ja, jsnap_a = _jax_snapshot(tmp_path / "jasync", True)
    js, jsnap_s = _jax_snapshot(tmp_path / "jsync", False)
    assert jsnap_a.async_saves_written > 0 and jsnap_s.async_saves_written == 0
    for port, ref in ((sa, ja), (ss, js)):
        _assert_arrays(port, ref, exact=False)
        _assert_meta_equal(port, ref, same_streams=False)
        np.testing.assert_allclose(port["metric"], ref["metric"], rtol=1e-6)


def _blocked_writer():
    """Hold the background writer inside its first write until the
    returned event is set; record every path it writes."""
    from znicz_torch import snapshotter as snap_mod

    entered, gate, written = threading.Event(), threading.Event(), []
    write = snap_mod.write_host_pickle

    def slow(path, state, compression="gz"):
        entered.set()
        gate.wait(timeout=60)
        written.append((os.path.basename(path), state["epoch"]))
        write(path, state, compression)

    return entered, gate, written, slow


def test_backlog_coalesces_and_the_last_is_durable(tmp_path, monkeypatch):
    from znicz_torch import snapshotter as snap_mod

    with sample_config("mnist", **MNIST):
        wf = port_sample("mnist", tmp_path)
    snap = wf.snapshotter
    snap.interval = 2
    entered, gate, written, slow = _blocked_writer()
    monkeypatch.setattr(snap_mod, "write_host_pickle", slow)
    for epoch in range(5):
        wf.decision.epoch_number = epoch
        state = snap_mod.collect(wf, device_copies=True)
        tags = snap.tags_for(epoch, True)
        snap.save_async(state, tags)
        assert entered.wait(timeout=60)     # the first job is writing
    gate.set()
    snap.flush_async()
    # the first job was already being written; of the queued bests only
    # the newest survives, the interval saves (epochs 1 and 3) all do
    assert written == [("mnist_best.pickle.gz", 0),
                       ("mnist_epoch_1.pickle.gz", 1),
                       ("mnist_epoch_3.pickle.gz", 3),
                       ("mnist_best.pickle.gz", 4)]
    assert snap.async_saves_coalesced == 3
    assert snap.async_saves_written == 4
    assert snap.destination.endswith("mnist_best.pickle.gz")
    last = snap_mod.Snapshotter.load(snap.destination)
    assert last["epoch"] == 4
    np.testing.assert_array_equal(
        last["units"]["fwd0"]["weights"],
        wf.forwards[0].weights.detach().numpy())


def test_writer_errors_surface_on_flush(tmp_path, monkeypatch):
    from znicz_torch import snapshotter as snap_mod

    with sample_config("mnist", **MNIST):
        wf = port_sample("mnist", tmp_path)

    def broken(path, state, compression="gz"):
        raise OSError("disk full")

    monkeypatch.setattr(snap_mod, "write_host_pickle", broken)
    wf.snapshotter.save_async(snap_mod.collect(wf, device_copies=True),
                              ["best"])
    with pytest.raises(OSError, match="disk full"):
        wf.snapshotter.flush_async()
    wf.snapshotter.flush_async()                # raised once, then clear
