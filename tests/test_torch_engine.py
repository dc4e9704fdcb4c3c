"""The port's unit-at-a-time engine against the reference's on the CPU.

  - reduced MNIST, and CIFAR10 composed and under ``pallas_lrn``
    (``test_torch_samples.REDUCED``; the reference's Pallas LRN in
    interpret mode), through the port's ``engine.train`` on the unit
    graph and the reference's ``Workflow.run``: every TRAIN loss within
    ``STEP_TOL``, the final weights within ``W_TOL``, the confusion
    totals of the last epoch equal;
  - the port's unit engine against the port's ``FusedTrainer`` on the
    same samples, with ``tests/test_fused.py:55-66``'s tolerances (losses
    rtol 1e-4, weights rtol 2e-3 / atol 2e-5, confusions equal);
  - ``engine.train``'s choice: the unit graph by default, ``FusedTrainer``
    under ``root.common.engine.fused`` or ``--fused`` (both print the
    same JSON keys and write ``mnist_best.pickle.gz``), AlexNet's
    ``run()`` fused unless ``fused=False``, ``--master``/``--slave``
    refused;
  - snapshots: one the port writes restores in the reference's workflow,
    and one the reference writes in the port's, bit for bit, also one
    the reference writes under bf16 state, loaded with ``ml_dtypes``
    blocked; the serving
    load (``restore_inference``) takes the forward parameters alone;
  - MNIST resumed from its best snapshot (after ``tests/test_mnist.py``'s
    resume test);
  - ``lr_adjust`` (``exp``, gamma 0.9): the port's unit engine, its
    ``FusedTrainer`` and the reference's unit engine follow one schedule.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_layers import jax_params, jax_sample, port_sample, \
    sample_config
from test_torch_planner import knobs
from test_torch_samples import REDUCED
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent
#: final weights, port unit engine vs the reference's, after the reduced
#: runs (10 MNIST updates, 1 CIFAR10 update): the two libraries' sums
#: part in the last bits each step
W_TOL = {"rtol": 1e-3, "atol": 1e-5}
#: tests/test_fused.py:55-66, unit engine vs FusedTrainer
FUSED_LOSS_TOL = {"rtol": 1e-4}
FUSED_W_TOL = {"rtol": 2e-3, "atol": 2e-5}


def _record_train_losses(decision):
    """The reference Decision's TRAIN minibatch losses, in order."""
    losses, run = [], decision.run

    def record():
        if int(decision.minibatch_class) == 2:
            losses.append(float(decision.minibatch_loss))
        run()

    decision.run = record
    return losses


def _port_params(wf):
    from znicz_torch.weights import params_to_numpy

    return params_to_numpy(wf)


def _confusions(decision):
    """The last epoch's VALID and TRAIN confusion matrices, numpy."""
    out = []
    for klass in (1, 2):
        conf = decision.epoch_metrics[klass]["confusion"]
        out.append(conf.cpu().numpy() if torch.is_tensor(conf)
                   else np.asarray(conf))
    return out


@pytest.mark.parametrize("sample,routing", [
    ("mnist", "composed"), ("cifar", "composed"), ("cifar", "pallas_lrn")])
def test_unit_engine_matches_reference(sample, routing, tmp_path):
    from znicz_torch import engine

    knob_set = {"pallas_lrn": True} if routing == "pallas_lrn" else {}
    with sample_config(sample, **REDUCED[sample]), knobs(**knob_set):
        jwf = jax_sample(sample, tmp_path / "ref")
        j_losses = _record_train_losses(jwf.decision)
        jwf.run()
        twf = port_sample(sample, tmp_path / "port")
        stats = engine.train(twf, fused=False)
    assert not hasattr(twf, "trainer")
    cfg = REDUCED[sample]
    n = cfg["decision__max_epochs"] * cfg["loader__n_train"] \
        // cfg["loader__minibatch_size"]
    assert len(twf.decision.train_losses) == len(j_losses) == n
    assert stats["train_steps"] == n - 1          # the last tail is skipped
    np.testing.assert_allclose(twf.decision.train_losses, j_losses,
                               **STEP_TOL)
    got, want = _port_params(twf), jax_params(jwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v,
                                       err_msg=f"{name}.{k}", **W_TOL)
    for got_c, want_c in zip(_confusions(twf.decision),
                             _confusions(jwf.decision)):
        np.testing.assert_array_equal(got_c, want_c)
    assert bool(twf.decision.complete)


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_unit_engine_matches_fused_trainer(sample, tmp_path):
    from znicz_torch import engine

    with sample_config(sample, **REDUCED[sample]):
        uwf = port_sample(sample, tmp_path)
        engine.train(uwf, fused=False)
        fwf = port_sample(sample, tmp_path)
        engine.train(fwf, fused=True)
    np.testing.assert_allclose(uwf.decision.train_losses,
                               fwf.trainer.train_losses, **FUSED_LOSS_TOL)
    got, want = _port_params(uwf), _port_params(fwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v,
                                       err_msg=f"{name}.{k}", **FUSED_W_TOL)
    for got_c, want_c in zip(_confusions(uwf.decision),
                             _confusions(fwf.decision)):
        np.testing.assert_array_equal(got_c, want_c)
        assert want_c.sum() > 0


@pytest.mark.parametrize("flag", ["unit", "fused"])
def test_cli_trains_on_the_engine_asked_for(flag, tmp_path):
    """``python -m znicz_torch mnist`` trains on the unit graph, with
    ``--fused`` on ``FusedTrainer``; both print the same keys and write
    the best snapshot."""
    over = [f"root.mnist.{k.replace('__', '.')}={v}"
            for k, v in REDUCED["mnist"].items()]
    cmd = [sys.executable, "-m", "znicz_torch", "mnist", "--device", "cpu",
           f"root.common.dirs.snapshots={tmp_path}", *over]
    if flag == "fused":
        cmd.append("--fused")
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"workflow", "device", "epochs", "valid_err_pct",
                        "train_loss", "final_train_loss", "train_steps",
                        "img_per_sec", "warm_img_per_sec", "compute_dtype"}
    assert res["epochs"] == 2 and res["train_steps"] == 9
    assert res["compute_dtype"] == "float32"
    assert res["img_per_sec"] > 0 and np.isfinite(res["final_train_loss"])
    assert ("gd1 " in out.stderr) == (flag == "unit")   # the unit table
    assert (tmp_path / "mnist_best.pickle.gz").is_file()


def test_engine_flag_picks_the_fused_trainer(tmp_path):
    from znicz_torch import engine
    from znicz_torch.core.config import root as troot

    with sample_config("mnist", **REDUCED["mnist"]):
        troot.common.engine.fused = True
        try:
            fwf = port_sample("mnist", tmp_path)
            engine.train(fwf)
        finally:
            troot.common.engine.fused = False
        uwf = port_sample("mnist", tmp_path)
        stats = engine.train(uwf)
    assert fwf.trainer.stats["train_steps"] == 9
    assert all(gd.run_count == 0 for gd in fwf.gd_units)
    assert not hasattr(uwf, "trainer")
    assert [gd.run_count for gd in uwf.gd_units] == [9, 9]
    assert stats == uwf.train_stats and stats["train_steps"] == 9


@pytest.mark.parametrize("fused", [None, True, False])
def test_alexnet_run_is_fused_unless_asked(fused, monkeypatch):
    """The reference's ``samples.alexnet.run`` takes ``fused=True``: the
    port's hands ``engine.train`` the same choice."""
    from znicz_torch import engine
    from znicz_torch.samples import alexnet

    seen = []
    monkeypatch.setattr(engine, "train",
                        lambda wf, fused=None, mesh=None:
                        seen.append(fused) or
                        {"train_steps": 0, "img_per_sec": 0.0,
                         "warm_img_per_sec": 0.0})
    with sample_config("alexnet", loader__image_size=67, loader__n_train=4,
                       loader__n_valid=2, loader__minibatch_size=2,
                       loader__n_classes=10):
        kw = {} if fused is None else {"fused": fused}
        alexnet.run(device="cpu", **kw)
    assert seen == [True if fused is None else fused]


@pytest.mark.parametrize("mode", ["master", "slave"])
def test_master_and_slave_are_not_ported(mode, tmp_path):
    """The roles are ported: under ``mode`` ``engine.train`` serves the
    job stream (master) or works for a master (slave), the other role
    played by the port's ``Server`` or ``Client``; the slave's own loader
    never advances (the master owns the stream)."""
    import threading

    from znicz_torch import engine
    from znicz_torch.client import Client
    from znicz_torch.core.config import root as troot
    from znicz_torch.server import Server

    with sample_config("mnist", **REDUCED["mnist"]):
        wf = port_sample("mnist", tmp_path / "wf")
        peer_wf = port_sample("mnist", tmp_path / "peer")
    troot.common.engine.mode = mode
    troot.common.engine.master_bind = "tcp://127.0.0.1:*"
    try:
        if mode == "master":
            result = {}
            thread = threading.Thread(
                target=lambda: result.update(engine.train(wf)),
                daemon=True)
            thread.start()
            t0 = time.perf_counter()
            while getattr(getattr(wf, "server", None), "endpoint",
                          "*").endswith("*"):
                assert time.perf_counter() - t0 < 120, "never bound"
                time.sleep(0.02)
            Client(peer_wf, endpoint=wf.server.endpoint).run()
            thread.join(120)
            assert result["train_steps"] == wf.server.jobs_done > 0
            assert bool(wf.decision.complete)
        else:
            server = Server(peer_wf).start()
            troot.common.engine.slave_endpoint = server.endpoint
            stats = engine.train(wf)
            assert server.join(120)
            assert stats["train_steps"] == wf.client.jobs_done \
                == server.jobs_done > 0
            assert wf.loader.samples_served == 0
    finally:
        troot.common.engine.mode = ""
        troot.common.engine.master_bind = "tcp://*:5570"
        troot.common.engine.slave_endpoint = None


def _assert_same_state(jwf, twf):
    want, got = jax_params(jwf), _port_params(twf)
    assert sorted(got) == sorted(want)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[name][k], v)
    for jgd in jwf.gds:
        tgd = next(g for g in twf.gd_units if g.name == jgd.name)
        assert set(tgd.velocities) == set(jgd._velocities)
        for k, a in jgd._velocities.items():
            np.testing.assert_array_equal(tgd.velocities[k].numpy(),
                                          np.array(a.map_read()))
    np.testing.assert_array_equal(twf.loader._shuffled_indices,
                                  jwf.loader._shuffled_indices)
    assert twf.loader.epoch_number == jwf.loader.epoch_number
    assert twf.decision.best_metric == jwf.decision.best_metric


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_snapshots_cross_load(direction, tmp_path):
    """A snapshot written after training restores into a fresh workflow
    of the other package: parameters, velocities (keyed by GD unit
    name), the loader's order and the Decision's best, bit for bit."""
    from znicz_torch import engine
    from znicz_torch.snapshotter import Snapshotter as TSnap
    from znicz_torch.snapshotter import restore as trestore
    from znicz_tpu.snapshotter import Snapshotter as JSnap
    from znicz_tpu.snapshotter import restore as jrestore

    with sample_config("mnist", **REDUCED["mnist"]):
        if direction == "port_to_reference":
            trained = port_sample("mnist", tmp_path)
            engine.train(trained, fused=False)
            path = trained.snapshotter.save("final")
            fresh = jax_sample("mnist", tmp_path / "ref")
            jrestore(fresh, JSnap.load(path))
            _assert_same_state(fresh, trained)
        else:
            trained = jax_sample("mnist", tmp_path)
            trained.run()
            path = trained.snapshotter.save("final")
            fresh = port_sample("mnist", tmp_path / "port")
            trestore(fresh, TSnap.load(path))
            _assert_same_state(trained, fresh)
    assert path.endswith("mnist_final.pickle.gz")


def test_reference_bf16_state_snapshot_loads_without_ml_dtypes(
        monkeypatch, tmp_path):
    """A snapshot the reference writes under ``state_dtype`` bfloat16
    pickles its velocities as ``ml_dtypes`` bf16 arrays.  With
    ``ml_dtypes`` blocked, the port loads them as float32 leaves of the
    same values, bit for bit, and restores them into a fresh port
    workflow; every other leaf loads as it was written."""
    import ml_dtypes

    from znicz_torch.snapshotter import Snapshotter as TSnap
    from znicz_torch.snapshotter import restore as trestore
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.snapshotter import Snapshotter as JSnap

    jroot.common.engine.state_dtype = "bfloat16"
    try:
        with sample_config("mnist", **REDUCED["mnist"]):
            trained = jax_sample("mnist", tmp_path)
            trained.run()
            path = trained.snapshotter.save("final")
            fresh = port_sample("mnist", tmp_path / "port")
    finally:
        jroot.common.engine.state_dtype = "float32"
    want = JSnap.load(path)
    leaves = [v for vs in want["velocities"].values() for v in vs.values()]
    assert leaves and {v.dtype for v in leaves} == {
        np.dtype(ml_dtypes.bfloat16)}
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)    # import fails
        got = TSnap.load(path)
    for name, vs in want["velocities"].items():
        for k, v in vs.items():
            leaf = got["velocities"][name][k]
            assert leaf.dtype == np.float32
            np.testing.assert_array_equal(
                leaf.view(np.uint32), v.astype(np.float32).view(np.uint32))
    for name, ps in want["units"].items():
        for k, v in ps.items():
            assert got["units"][name][k].dtype == v.dtype
            np.testing.assert_array_equal(got["units"][name][k], v)
    assert got["loader"].keys() == want["loader"].keys()
    trestore(fresh, got)
    for gd in fresh.gd_units:
        for k, v in gd.velocities.items():
            np.testing.assert_array_equal(
                v.numpy(), want["velocities"][gd.name][k].astype(np.float32))


def test_mnist_resumes_from_its_best_snapshot(tmp_path):
    from znicz_torch.core import prng
    from znicz_torch.core.config import root as troot
    from znicz_torch.samples import mnist
    from znicz_torch.snapshotter import Snapshotter, restore

    troot.common.dirs.snapshots = str(tmp_path)
    with sample_config("mnist", loader__n_train=600, loader__n_valid=120,
                       loader__n_test=0, loader__minibatch_size=60,
                       decision__max_epochs=3):
        prng.reset(1013)
        wf = mnist.run(device="cpu")
        path = wf.snapshotter.destination
        assert path and path.endswith("mnist_best.pickle.gz")
        snap = Snapshotter.load(path)
        assert all(isinstance(v, np.ndarray)
                   for leaves in snap["units"].values()
                   for v in leaves.values())
        with sample_config("mnist", decision__max_epochs=5):
            prng.reset(1013)
            wf2 = mnist.MnistWorkflow("cpu")
            restore(wf2, snap)
            np.testing.assert_array_equal(
                wf2.forwards[0].weights.detach().numpy(),
                snap["units"]["fwd0"]["weights"])
            assert wf2.decision.best_metric == snap["decision"]["best_metric"]
            wf3 = mnist.run(device="cpu", snapshot=path)
    assert bool(wf3.decision.complete)
    assert int(wf3.decision.epoch_number) == 4
    assert wf3.train_stats["train_steps"] == \
        (4 - snap["epoch"]) * 10 - 1
    assert wf3.decision.best_metric <= snap["decision"]["best_metric"] + 1e-9


def test_lr_adjust_follows_the_reference(tmp_path):
    """``exp`` with gamma 0.9 over three epochs of reduced CIFAR10 (5
    updates): the port's unit engine and its FusedTrainer against the
    reference's unit engine, every TRAIN loss and the final rates."""
    from znicz_torch import engine
    from znicz_torch.core import prng as tprng
    from znicz_torch.samples import cifar as tcifar
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.samples import cifar as jcifar

    lr = {"policy": "exp", "gamma": 0.9}
    with sample_config("cifar", **dict(REDUCED["cifar"],
                                       decision__max_epochs=3)):
        jroot.common.dirs.snapshots = str(tmp_path)
        jprng.reset(1013)
        jwf = jcifar.CifarWorkflow(lr_adjust_config=lr)
        jwf.initialize(device=None)
        j_losses = _record_train_losses(jwf.decision)
        jwf.run()
        runs = {}
        for fused in (False, True):
            port_sample("cifar", tmp_path)
            tprng.reset(1013)
            twf = tcifar.CifarWorkflow("cpu", lr_adjust_config=lr)
            engine.train(twf, fused=fused)
            runs[fused] = twf
    assert jwf.lr_adjust.iteration == 5
    for fused, twf in runs.items():
        assert twf.lr_adjust.iteration == 5
        np.testing.assert_allclose(twf.decision.train_losses, j_losses,
                                   **STEP_TOL)
        for jgd in jwf.gds:
            tgd = next(g for g in twf.gd_units if g.name == jgd.name)
            assert tgd.learning_rate == pytest.approx(jgd.learning_rate,
                                                      rel=1e-12)
        for tgd in twf.gds.values():                  # CIFAR10's lr 0.02
            assert tgd.learning_rate == pytest.approx(0.02 * 0.9 ** 4,
                                                      rel=1e-12)
    np.testing.assert_allclose(runs[False].decision.train_losses,
                               runs[True].decision.train_losses,
                               **FUSED_LOSS_TOL)


def test_restore_inference_and_atomic_write(tmp_path):
    """The serving load takes a reference snapshot's forward parameters
    alone (the loader and the Decision keep their state) and refuses one
    that misses a module with weights; ``atomic_write_bytes`` leaves the
    bytes and no temporary file."""
    from znicz_torch.snapshotter import atomic_write_bytes, \
        restore_inference
    from znicz_tpu.snapshotter import collect

    with sample_config("mnist", **REDUCED["mnist"]):
        jwf = jax_sample("mnist", tmp_path)
        jwf.run()
        snap = collect(jwf)
        twf = port_sample("mnist", tmp_path)
    restore_inference(twf, snap)
    got, want = _port_params(twf), jax_params(jwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[name][k], v)
    assert twf.loader.epoch_number == 0 and twf.decision.best_epoch == -1
    del snap["units"]["fwd1"]
    with pytest.raises(ValueError, match="fwd1"):
        restore_inference(twf, snap)
    path = tmp_path / "blob.bin"
    atomic_write_bytes(str(path), b"\x00abc")
    assert path.read_bytes() == b"\x00abc"
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("blob")) == ["blob.bin"]
