"""The snapshot formats on the CPU, against the reference:

  - the orbax format (``Snapshotter(format="orbax")``): a directory with
    ``meta.json`` and ``arrays/`` (``torch.distributed.checkpoint``),
    whose leaves and metadata are the host pickle's bit for bit, which
    restores into a fresh workflow and trains on to the bits of the
    pickle's restore (after ``tests/test_services.py:399``); its
    ``meta.json`` round-trips numpy state exactly;
  - the reference's own orbax directory (OCDBT + zarr, written by
    ``znicz_tpu`` here) loads into the port with equal leaves and
    metadata, float32 and bf16 state, and restores through
    ``restore_sharded``;
  - ``compression`` other than "gz" writes and reads a plain ``.pickle``,
    both ways between the packages;
  - ``FusedTrainer.restore_sharded`` crosses precision: a float32
    snapshot restores under bf16 state and the reverse, and the run goes
    on (after ``tests/test_async_snapshot.py:188-241``);
  - an orbax-format snapshotter keeps ``pipeline_depth`` > 1 on the
    segmented run and saves in line (after ``tests/test_fused.py:705``);
  - ``load_inference`` gives back the trained forward parameters and
    refuses a snapshot that does not cover the model (after
    ``tests/test_serving.py:342``);
  - the CLI reads ``snapshot_format``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_layers import jax_sample, port_sample, sample_config
from test_torch_samples import REDUCED
from test_torch_segments import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a reduced MNIST: 2 TRAIN minibatches an epoch
MNIST = {"loader__n_train": 120, "loader__n_valid": 60, "loader__n_test": 0,
         "loader__minibatch_size": 60, "decision__max_epochs": 2}


def _trained(tmp_path, **knobs):
    """A port MNIST workflow after a seeded 2-epoch fused run, and its
    trainer."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST), engine(**knobs):
        wf = port_sample("mnist", tmp_path)
        trainer = FusedTrainer(wf)
        trainer.run()
    return wf, trainer


def _assert_trees_equal(a, b, groups=("units", "velocities")):
    for group in groups:
        assert set(a[group]) == set(b[group]), group
        for name, leaves in a[group].items():
            assert set(leaves) == set(b[group][name])
            for k, x in leaves.items():
                y = b[group][name][k]
                assert np.asarray(x).dtype == np.asarray(y).dtype == \
                    np.float32
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{k}")


def _assert_meta_equal(a, b):
    for key in ("epoch_number", "samples_served", "last_minibatch"):
        assert a["loader"][key] == b["loader"][key], key
    np.testing.assert_array_equal(a["loader"]["shuffled_indices"],
                                  b["loader"]["shuffled_indices"])
    assert a["decision"] == b["decision"]
    assert a["epoch"] == b["epoch"] and a["metric"] == b["metric"]
    assert repr(a["prng"]) == repr(b["prng"])


def _resume(tmp_path, apply, epochs=4):
    """A fresh port MNIST workflow, ``apply(wf, trainer)`` restoring a
    snapshot into it, then run to ``epochs``: its TRAIN losses and
    parameters."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **dict(MNIST,
                                       decision__max_epochs=epochs)):
        wf = port_sample("mnist", tmp_path)
        trainer = FusedTrainer(wf)
        apply(wf, trainer)
        trainer.run()
    assert bool(wf.decision.complete)
    return (list(wf.decision.train_losses),
            {n: {k: p.detach().clone() for k, p in leaves.items()}
             for n, leaves in trainer.extract_params().items()})


def test_orbax_round_trip_is_the_pickle_bit_for_bit(tmp_path):
    """One trained state saved both ways: the orbax directory's leaves
    and metadata are the pickle's; each restores into a fresh workflow
    that trains two more epochs to the same bits."""
    from znicz_torch.snapshotter import Snapshotter, restore

    wf, _ = _trained(tmp_path)
    snap_unit = wf.snapshotter
    snap_unit.format = "orbax"
    path = snap_unit.save("orbax_test")
    assert path.endswith("mnist_orbax_test.orbax") and os.path.isdir(path)
    assert sorted(os.listdir(path)) == ["arrays", "meta.json"]
    assert os.path.exists(os.path.join(path, "arrays", ".metadata"))
    snap_unit.format = "pickle"
    pickled = Snapshotter.load(snap_unit.save("pickle_test"))
    orbax = Snapshotter.load(path)
    _assert_trees_equal(orbax, pickled)
    _assert_meta_equal(orbax, pickled)
    assert orbax["epoch"] == 1
    w0 = wf.forwards[0].weights.detach().numpy()
    np.testing.assert_array_equal(orbax["units"]["fwd0"]["weights"], w0)
    a = _resume(tmp_path, lambda w, t: restore(w, orbax))
    b = _resume(tmp_path, lambda w, t: restore(w, pickled))
    assert a[0] == b[0] and len(a[0]) == 4
    for name, leaves in a[1].items():
        for k, p in leaves.items():
            assert torch.equal(p, b[1][name][k]), f"{name}.{k}"


def test_orbax_meta_round_trips_numpy_state(tmp_path):
    """Arrays in the metadata (a large one as base64, a small one as a
    list), numpy scalars and an infinite metric come back exactly."""
    from znicz_torch.snapshotter import (_load_orbax, load_orbax_meta,
                                         save_orbax)

    mean = np.linspace(0, 1, 2000).astype(np.float32)
    snap = {"units": {"f": {"weights": torch.ones((2, 2))}},
            "velocities": {},
            "loader": {"epoch_number": np.int64(2),
                       "normalizer": {"mean": mean,
                                      "disp": np.arange(3.0)}},
            "decision": {"best_metric": np.inf}, "metric": np.float32(0.5)}
    path = str(tmp_path / "m.orbax")
    save_orbax(path, snap)
    meta = load_orbax_meta(path)
    np.testing.assert_array_equal(meta["loader"]["normalizer"]["mean"], mean)
    assert meta["loader"]["normalizer"]["mean"].dtype == np.float32
    np.testing.assert_array_equal(meta["loader"]["normalizer"]["disp"],
                                  np.arange(3.0))
    assert meta["loader"]["epoch_number"] == 2
    assert meta["decision"]["best_metric"] == np.inf and meta["metric"] == 0.5
    full = _load_orbax(path)
    np.testing.assert_array_equal(full["units"]["f"]["weights"],
                                  np.ones((2, 2), np.float32))
    save_orbax(path, snap)                # a second save replaces the first
    assert sorted(os.listdir(path)) == ["arrays", "meta.json"]


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_reference_orbax_directory_loads_into_the_port(state, tmp_path):
    """The reference trains MNIST (velocities in ``state``) and writes its
    orbax directory; the port's ``Snapshotter.load`` reads it through
    tensorstore with the reference's own load's leaves (bf16 widened)
    and metadata; ``restore`` and ``restore_sharded`` put those
    parameters and velocities into a port workflow."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter

    with sample_config("mnist", **MNIST), engine(state_dtype=state):
        jwf = jax_sample("mnist", tmp_path)
        JTrainer(jwf).run()
        jwf.snapshotter.format = "orbax"
        path = jwf.snapshotter.save("ref")
    assert os.path.exists(os.path.join(path, "arrays", "_METADATA"))
    want = JSnapshotter.load(path)
    assert str(np.asarray(want["velocities"]["gd0"]["weights"]).dtype) == \
        state
    got = Snapshotter.load(path)
    for group in ("units", "velocities"):
        assert set(got[group]) == set(want[group])
        for name, leaves in want[group].items():
            for k, a in leaves.items():
                a = np.asarray(a).astype(np.float32)
                assert got[group][name][k].dtype == np.float32
                np.testing.assert_array_equal(got[group][name][k], a)
    _assert_meta_equal(got, want)
    with sample_config("mnist", **MNIST):
        twf = port_sample("mnist", tmp_path)
        restore(twf, got)
        t = FusedTrainer(twf)
        t.restore_sharded(path)
    for f in twf.forwards:
        for k, p in t._params_of(f).items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          got["units"][f.name][k])
    for gd in twf.gds.values():
        for k, v in gd.velocities.items():
            np.testing.assert_array_equal(v.numpy(),
                                          got["velocities"][gd.name][k])


def test_reference_directory_without_tensorstore_names_it(tmp_path,
                                                          monkeypatch):
    """Where ``tensorstore`` does not import, loading the reference's
    directory raises an error that names it."""
    from znicz_torch.snapshotter import Snapshotter

    arrays = tmp_path / "ref.orbax" / "arrays"
    arrays.mkdir(parents=True)
    (tmp_path / "ref.orbax" / "meta.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="tensorstore"):
        Snapshotter.load(str(tmp_path / "ref.orbax"))


def test_plain_pickle_both_ways(tmp_path):
    """``compression`` other than "gz": the port writes a plain
    ``.pickle`` the reference loads, and loads the reference's."""
    from znicz_torch.snapshotter import Snapshotter
    from znicz_tpu.snapshotter import Snapshotter as JSnapshotter

    wf, _ = _trained(tmp_path)
    wf.snapshotter.compression = "none"
    path = wf.snapshotter.save("plain")
    assert path.endswith("mnist_plain.pickle")
    with open(path, "rb") as f:                 # not gzip: a pickle
        assert f.read(1) == b"\x80"
    _assert_trees_equal(JSnapshotter.load(path), Snapshotter.load(path))
    with sample_config("mnist", **MNIST):
        jwf = jax_sample("mnist", tmp_path / "ref")
        jwf.snapshotter.compression = ""
        jpath = jwf.snapshotter.save("plain")
    assert jpath.endswith("mnist_plain.pickle")
    got, want = Snapshotter.load(jpath), JSnapshotter.load(jpath)
    for name, leaves in want["units"].items():
        for k, a in leaves.items():
            np.testing.assert_array_equal(got["units"][name][k], a)


@pytest.mark.parametrize("saved,resumed", [("float32", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_restore_sharded_crosses_precision(saved, resumed, tmp_path):
    """A sharded orbax snapshot saved with velocities in ``saved``
    (stored in that dtype) restores under ``resumed`` state: each leaf
    cast to the live dtype, the loader and Decision as saved, and the run
    goes on to its end."""
    from torch.distributed.checkpoint import FileSystemReader

    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import load_orbax_arrays

    wf, _ = _trained(tmp_path, state_dtype=saved, snapshot_format="orbax",
                     snapshot_sharded=True)
    path = wf.snapshotter.destination
    assert path.endswith("mnist_best.orbax")
    md = FileSystemReader(os.path.join(path, "arrays")).read_metadata()
    stored = {fqn: m.properties.dtype
              for fqn, m in md.state_dict_metadata.items()}
    assert stored["velocities.gd0.weights"] == getattr(torch, saved)
    assert stored["units.fwd0.weights"] == torch.float32
    whole = load_orbax_arrays(path)
    with sample_config("mnist", **dict(MNIST, decision__max_epochs=4)), \
            engine(state_dtype=resumed):
        wf2 = port_sample("mnist", tmp_path / "resume")
        t2 = FusedTrainer(wf2)
        meta = t2.restore_sharded(path)
        for gd in wf2.gds.values():
            for k, v in gd.velocities.items():
                assert v.dtype == getattr(torch, resumed)
                want = torch.from_numpy(whole["velocities"][gd.name][k])
                assert torch.equal(v, want.to(v.dtype))
        assert wf2.loader.epoch_number == meta["loader"]["epoch_number"]
        assert wf2.decision.best_metric == meta["decision"]["best_metric"]
        t2.run()
    assert bool(wf2.decision.complete)
    assert len(wf2.decision.train_losses) == 4
    assert np.isfinite(wf2.decision.train_losses).all()


def test_orbax_snapshotter_keeps_the_deep_pipeline_segmented(tmp_path):
    """``pipeline_depth`` 3 with an orbax-format snapshotter runs the
    segmented loop (its save is a synchronous collective) and writes the
    directory in line; a host-format one takes the deep pipeline;
    ``save_async`` refuses the orbax format."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **MNIST), \
            engine(pipeline_depth=3, snapshot_format="orbax"):
        wf = port_sample("mnist", tmp_path)
        trainer = FusedTrainer(wf)
        assert trainer.pipeline_depth == 3 and not trainer._deep_eligible()
        trainer.run()
        with pytest.raises(ValueError, match="host format"):
            wf.snapshotter.save_async({}, ["best"])
    assert trainer.stats["deep_epochs"] == 0
    assert wf.snapshotter.async_saves_written == 0
    assert os.path.isdir(wf.snapshotter.destination)
    assert wf.snapshotter.destination.endswith(".orbax")
    with sample_config("mnist", **MNIST), engine(pipeline_depth=3):
        assert FusedTrainer(port_sample("mnist", tmp_path))._deep_eligible()


@pytest.mark.parametrize("fmt", ["pickle", "orbax"])
def test_load_inference_gives_the_trained_forward(fmt, tmp_path):
    """``load_inference`` puts the trained forward parameters into a fresh
    workflow and returns the metadata without the arrays; a snapshot
    that does not cover every weighted forward is refused."""
    from znicz_torch.nn_units import params_of
    from znicz_torch.snapshotter import Snapshotter, load_inference, \
        write_host_pickle

    wf, _ = _trained(tmp_path)
    wf.snapshotter.format = fmt
    path = wf.snapshotter.save("serve")
    trained = {f.name: {k: p.detach().clone()
                        for k, p in params_of(f).items()}
               for f in wf.forwards}
    with sample_config("mnist", **MNIST):
        fresh = port_sample("mnist", tmp_path)
    meta = load_inference(fresh, path)
    assert "units" not in meta and "velocities" not in meta
    assert meta["epoch"] == 1
    for f in fresh.forwards:
        for k, p in params_of(f).items():
            assert torch.equal(p, trained[f.name][k]), f"{f.name}.{k}"
    snap = Snapshotter.load(path)
    del snap["units"]["fwd1"]
    partial = str(tmp_path / "partial.pickle.gz")
    write_host_pickle(partial, snap)
    with pytest.raises(ValueError, match=r"fwd1"):
        load_inference(fresh, partial)


def test_cli_reads_the_snapshot_format(tmp_path):
    """``python -m znicz_torch mnist
    root.common.engine.snapshot_format='orbax'`` trains and writes its
    best snapshot as an orbax directory."""
    over = [f"root.mnist.{k.replace('__', '.')}={v}"
            for k, v in REDUCED["mnist"].items()]
    cmd = [sys.executable, "-m", "znicz_torch", "mnist", "--device", "cpu",
           f"root.common.dirs.snapshots={tmp_path}", *over,
           "root.common.engine.snapshot_format='orbax'"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    best = tmp_path / "mnist_best.orbax"
    assert sorted(os.listdir(best)) == ["arrays", "meta.json"]
    with open(best / "meta.json") as f:
        assert '"epoch"' in f.read()
    assert not any(p.name.endswith(".pickle.gz") for p in tmp_path.iterdir())


def test_snapshot_pickles_hold_no_torch_object(tmp_path):
    """A plain pickle of the port opens with the standard unpickler and
    holds numpy leaves only."""
    wf, _ = _trained(tmp_path)
    wf.snapshotter.compression = "none"
    with open(wf.snapshotter.save("numpy"), "rb") as f:
        snap = pickle.load(f)
    for group in ("units", "velocities"):
        for leaves in snap[group].values():
            assert all(type(a) is np.ndarray for a in leaves.values())
