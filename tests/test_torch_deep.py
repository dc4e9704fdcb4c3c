"""The port's deep pipeline (``FusedTrainer`` at ``pipeline_depth`` above
1, the reference's ``_run_deep``) on the CPU, against the port's own
segmented run and against the reference's deep run.

  - reduced MNIST at depth 3 over 7 epochs (a fill, a flush of 3, the
    drain) and reduced CIFAR10 under ``pallas_lrn`` + ``fused_tail`` at
    depth 2: losses, weights, velocities and confusions bit-equal to the
    segmented run, the same step and image counts;
  - the reference's deep run from the same seed and weights within
    ``STEP_TOL``;
  - with an ``exp`` schedule to ``max_epochs``: the same bits, the
    schedule's iteration and rates; an epoch's rows (``_epoch_hypers``)
    against the reference's;
  - a ``fail_iterations`` stop found late (depth 4): the stopping state
    bit-equal to the segmented run's (weights, velocities, ``steps_done``,
    the loader, the prng streams, the ``lr_adjust`` iteration and rates),
    the reference's stop epoch and ``steps_done``;
  - which runs stay segmented (``_deep_eligible``);
  - the deep run's snapshots equal the segmented run's, and its async
    snapshot resumes on the port's three engines and on the reference;
  - ``LearningRateAdjust.restore_iteration`` against the reference's;
  - an epoch is queued without reading a tensor back;
  - the compiler knobs ``backend``, ``fuse`` and ``xla_latency_hiding``,
    and the CLI with ``pipeline_depth``.
"""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_async_snapshot import _assert_arrays, _assert_meta_equal
from test_torch_engine import FUSED_LOSS_TOL, FUSED_W_TOL
from test_torch_layers import jax_params, jax_sample, port_sample, \
    sample_config
from test_torch_segments import ROUTING, SEGMENTED, assert_same_bits, \
    engine, port_state
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent

#: (sample, depth, epochs): MNIST fills 6 epochs, flushes 3, queues the
#: last and drains 4; CIFAR10 queues all 3 and drains them
DEEP_RUNS = [("mnist", 3, 7), ("cifar", 2, 3)]
#: the reference's fail-stop test: a rate so small that validation stops
#: improving, a stop after 2 epochs without improvement
FAILSTOP = dict(SEGMENTED["mnist"], learning_rate=1e-4,
                decision__max_epochs=50, decision__fail_iterations=2)


def run_port(sample, tmp_path, depth, **knobs):
    """The port's trainer after a seeded run of ``sample`` at
    ``pipeline_depth`` ``depth``."""
    from znicz_torch.parallel.fused import FusedTrainer

    with engine(pipeline_depth=depth, **knobs):
        wf = port_sample(sample, tmp_path)
        trainer = FusedTrainer(wf)
        assert trainer.pipeline_depth == depth
        trainer.run()
    return trainer


def run_reference(sample, tmp_path, depth):
    """(reference workflow, its trainer, its TRAIN losses) of a seeded
    run with the trainer's ``pipeline_depth`` set to ``depth``."""
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    jwf = jax_sample(sample, tmp_path)
    jt = JTrainer(jwf)
    jt.pipeline_depth = depth
    assert jt._deep_eligible()
    losses = []
    feed = jt._feed_decision

    def record(mb, metrics):
        if mb["class"] == 2:
            losses.append(float(metrics[0]))
        feed(mb, metrics)

    jt._feed_decision = record
    jt.run()
    return jwf, jt, losses


def streams():
    from znicz_torch.core import prng

    return {name: repr(s.state.bit_generator.state)
            for name, s in prng._streams.items()}


@pytest.mark.parametrize("sample,depth,epochs", DEEP_RUNS)
def test_deep_is_the_segmented_run_bit_for_bit(sample, depth, epochs,
                                               tmp_path):
    cfg = dict(SEGMENTED[sample], decision__max_epochs=epochs)
    with sample_config(sample, **cfg):
        seg = run_port(sample, tmp_path, 1, **ROUTING[sample])
        deep = run_port(sample, tmp_path, depth, **ROUTING[sample])
    assert seg.stats["deep_epochs"] == 0
    st = deep.stats
    assert st["deep_epochs"] == st["deep_flushes"] == epochs
    assert st["deep_inflight_max"] == min(epochs, 2 * depth)
    assert st["deep_pulls"] == (2 if epochs > 2 * depth else 1)
    assert st["deep_rollbacks"] == 0
    for key in ("train_steps", "eval_steps", "images"):
        assert st[key] == seg.stats[key], key
    assert deep.steps_done == seg.steps_done == 10 * epochs
    assert deep.segments == seg.segments
    assert_same_bits(port_state(seg), port_state(deep))
    assert deep.loader.epoch_number == seg.loader.epoch_number
    assert deep.loader.samples_served == seg.loader.samples_served
    assert deep.decision.best_metric == seg.decision.best_metric


def test_deep_matches_the_reference_deep_run(tmp_path):
    from znicz_torch.weights import params_to_numpy

    cfg = dict(SEGMENTED["mnist"], decision__max_epochs=4)
    with sample_config("mnist", **cfg):
        jwf, jt, j_losses = run_reference("mnist", tmp_path, 3)
        t = run_port("mnist", tmp_path, 3)
    assert len(t.train_losses) == len(j_losses) == 40
    np.testing.assert_allclose(t.train_losses, j_losses, **STEP_TOL)
    got, want = params_to_numpy(t.workflow), jax_params(jwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v, err_msg=f"{name}.{k}",
                                       **STEP_TOL)
    assert t.steps_done == jt.steps_done
    for klass in (1, 2):
        np.testing.assert_array_equal(
            t.decision.epoch_metrics[klass]["confusion"].numpy(),
            np.asarray(jwf.decision.epoch_metrics[klass]["confusion"]))


def _schedule_workflow(tmp_path, max_epochs=50, fail_iterations=2):
    """The port's MNIST layers with an ``exp`` schedule, a rate small
    enough to fail-stop, and by default ``FAILSTOP``'s Decision."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples import mnist
    from znicz_torch.standard_workflow import StandardWorkflow

    root.common.dirs.snapshots = str(tmp_path)
    gd = {"learning_rate": 1e-4, "gradient_moment": 0.9}
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
               "<-": dict(gd)},
              {"type": "softmax", "->": {"output_sample_shape": 10},
               "<-": dict(gd)}]
    prng.reset(1013)
    return StandardWorkflow(
        layers, device="cpu", loader=mnist.MnistLoader(minibatch_size=60),
        loss_function="softmax",
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": fail_iterations},
        lr_adjust_config={"policy": "exp", "gamma": 0.9})


def test_schedule_ends_at_max_epochs_as_the_segmented_run(tmp_path):
    """The last tail's update is not applied, and the schedule is not
    advanced after it: 4 epochs of 10 updates less that one."""
    from znicz_torch.parallel.fused import FusedTrainer

    runs = {}
    with sample_config("mnist", **SEGMENTED["mnist"]):
        for depth in (1, 3):
            with engine(pipeline_depth=depth):
                t = FusedTrainer(_schedule_workflow(tmp_path, max_epochs=4,
                                                    fail_iterations=0))
                t.run()
            runs[depth] = t
    seg, deep = runs[1], runs[3]
    assert deep.stats["deep_epochs"] == 4
    assert_same_bits(port_state(seg), port_state(deep))
    assert deep.lr_adjust.iteration == seg.lr_adjust.iteration == 39
    for name, gd in deep.gd_of.items():
        assert gd.learning_rate == seg.gd_of[name].learning_rate
        assert gd.learning_rate_bias == seg.gd_of[name].learning_rate_bias


@pytest.mark.parametrize("schedule", [False, True])
def test_fail_stop_rolls_back_to_the_segmented_state(schedule, tmp_path):
    """The stop is found up to 8 epochs late: the tail's update and the
    later epochs are undone, and the host's state rewound."""
    from znicz_torch.parallel.fused import FusedTrainer

    runs = {}
    with sample_config("mnist", **FAILSTOP):
        for depth in (1, 4):
            if schedule:
                with engine(pipeline_depth=depth):
                    t = FusedTrainer(_schedule_workflow(tmp_path))
                    t.run()
            else:
                t = run_port("mnist", tmp_path, depth)
            ldr = t.loader
            runs[depth] = (t, streams(), np.array(ldr._shuffled_indices),
                           (ldr.epoch_number, ldr.samples_served, ldr._pos,
                            ldr.last_minibatch, list(ldr.class_samples_served)))
        if not schedule:
            jwf, jt, _ = run_reference("mnist", tmp_path, 4)
    (seg, seg_streams, seg_order, seg_ldr), (deep, deep_streams, deep_order,
                                             deep_ldr) = runs[1], runs[4]
    epochs = seg.decision.epoch_number + 1
    assert bool(seg.decision.complete) and epochs < 50
    st = deep.stats
    assert st["deep_rollbacks"] == 1 and st["deep_epochs"] > epochs
    assert st["deep_discarded_train_steps"] > 1
    for key in ("train_steps", "eval_steps", "images"):
        assert st[key] == seg.stats[key], key
    assert_same_bits(port_state(seg), port_state(deep))
    assert deep.steps_done == seg.steps_done == 10 * epochs
    assert deep_ldr == seg_ldr
    np.testing.assert_array_equal(deep_order, seg_order)
    assert deep_streams == seg_streams
    assert deep.decision.epoch_number == seg.decision.epoch_number
    assert deep.decision.best_metric == seg.decision.best_metric
    if schedule:
        assert deep.lr_adjust.iteration == seg.lr_adjust.iteration \
            == 10 * epochs - 1
        for name, gd in deep.gd_of.items():
            assert gd.learning_rate == seg.gd_of[name].learning_rate
            assert gd.learning_rate_bias == seg.gd_of[name].learning_rate_bias
    else:
        assert jwf.decision.epoch_number == seg.decision.epoch_number
        assert jt.steps_done == seg.steps_done


def test_deep_eligible_keeps_the_segmented_run_where_it_must(tmp_path):
    from test_torch_streaming import STREAM, _port_loader

    from znicz_torch.core.mutable import Bool
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples import mnist

    def trainer():
        with sample_config("mnist", **STREAM), engine(pipeline_depth=3):
            return FusedTrainer(port_sample("mnist", tmp_path))

    def eligible(t, async_snapshot=True):
        with engine(async_snapshot=async_snapshot):
            return t._deep_eligible()

    # an active snapshotter stays deep under async_snapshot only
    t = trainer()
    assert eligible(t) and not eligible(t, async_snapshot=False)
    t.workflow.snapshotter.gate_skip = Bool(True)       # gated off
    assert eligible(t, async_snapshot=False)
    t = trainer()
    t.workflow.plotters = [object()]
    assert not eligible(t)
    orig = mnist.MnistLoader
    mnist.MnistLoader = _port_loader(True, 0)           # host-staged
    try:
        t = trainer()
    finally:
        mnist.MnistLoader = orig
    assert t.staging and not eligible(t)
    with sample_config("mnist", **STREAM), engine(pipeline_depth=3):
        t.run()
    assert t.stats["deep_epochs"] == 0 and t.stats["staged_segments"] > 0
    assert bool(t.decision.complete)


@pytest.mark.parametrize("interval", [0, 1])
def test_deep_snapshots_equal_the_segmented_ones(interval, tmp_path):
    """Best-only, and a snapshot every epoch (each a flushed epoch's own
    state while later epochs are in flight): the arrays, the loader,
    the prng streams and the Decision exact."""
    from znicz_torch.snapshotter import Snapshotter

    cfg = dict(SEGMENTED["mnist"], decision__max_epochs=5,
               snapshotter__interval=interval)
    snaps = {}
    with sample_config("mnist", **cfg):
        for depth in (1, 2):
            t = run_port("mnist", tmp_path / f"d{depth}", depth)
            snap = t.workflow.snapshotter
            assert snap.async_saves_written > 0
            names = sorted(p.name for p in (tmp_path / f"d{depth}").iterdir())
            snaps[depth] = {n: Snapshotter.load(str(tmp_path / f"d{depth}"
                                                    / n)) for n in names}
    assert snaps[2].keys() == snaps[1].keys()
    assert len(snaps[1]) == (1 + 5 if interval else 1)
    for name, seg in snaps[1].items():
        deep = snaps[2][name]
        _assert_arrays(seg, deep, exact=True)
        _assert_meta_equal(seg, deep)
        assert seg["decision"] == deep["decision"]
        assert seg["metric"] == deep["metric"]


def test_deep_snapshot_resumes_on_every_engine(tmp_path):
    """A deep run's async snapshot (epoch 1 of 2) continued to epoch 4 on
    the port's segmented and deep runs (bit-equal), its unit engine, and
    the reference's fused trainer after a cross-load."""
    from znicz_torch import engine as tengine
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.snapshotter import Snapshotter, restore
    from znicz_torch.weights import params_to_numpy
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer
    from znicz_tpu.snapshotter import restore as jrestore

    with sample_config("mnist", **dict(SEGMENTED["mnist"],
                                       decision__max_epochs=2)):
        t = run_port("mnist", tmp_path / "first", 2)
    assert t.stats["deep_epochs"] == 2
    snap = Snapshotter.load(t.workflow.snapshotter.destination)
    assert snap["epoch"] == 1 and snap["loader"]["last_minibatch"]

    def resumed(kind):
        with sample_config("mnist", **dict(SEGMENTED["mnist"],
                                           decision__max_epochs=4)):
            if kind == "reference":
                jwf = jax_sample("mnist", tmp_path / kind)
                jrestore(jwf, snap)
                JTrainer(jwf).run()
                return jwf.decision, jax_params(jwf)
            wf = port_sample("mnist", tmp_path / kind)
            restore(wf, snap)
            if kind == "unit":
                tengine.train(wf, fused=False)
            else:
                with engine(pipeline_depth=3 if kind == "deep" else 1):
                    trainer = FusedTrainer(wf)
                    trainer.run()
                    wf.trainer = trainer
            return wf, params_to_numpy(wf)

    (seg, seg_w), (deep, deep_w) = resumed("segmented"), resumed("deep")
    assert deep.trainer.stats["deep_epochs"] == 2
    assert_same_bits(port_state(seg.trainer), port_state(deep.trainer))
    assert len(seg.decision.train_losses) == 20
    (unit, unit_w), (jdec, ref_w) = resumed("unit"), resumed("reference")
    assert bool(unit.decision.complete) and bool(jdec.complete)
    assert unit.decision.epoch_number == jdec.epoch_number == 3
    np.testing.assert_allclose(unit.decision.epoch_metrics[2]["loss"],
                               seg.decision.epoch_metrics[2]["loss"],
                               **FUSED_LOSS_TOL)
    np.testing.assert_allclose(jdec.epoch_metrics[2]["loss"],
                               seg.decision.epoch_metrics[2]["loss"],
                               **STEP_TOL)
    for name, leaves in seg_w.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(deep_w[name][k], v)
            np.testing.assert_allclose(unit_w[name][k], v, **FUSED_W_TOL)
            np.testing.assert_allclose(ref_w[name][k], v, **STEP_TOL)


@pytest.mark.parametrize("policy,kwargs", [
    ("step", {"gamma": 0.5, "step": 3}),
    ("inv", {"gamma": 0.01, "power": 0.75}),
    ("exp", {"gamma": 0.9})])
def test_restore_iteration_follows_the_reference(policy, kwargs):
    """Caffe policies: after runs and rewinds in both packages, the
    counters and every bound unit's rates are the reference's."""
    from znicz_torch import lr_adjust as tlr
    from znicz_tpu import lr_adjust as jlr

    units = {}
    for pkg, mod in (("port", tlr), ("reference", jlr)):
        adj = mod.LearningRateAdjust(name="lr_adjust")
        gds = [types.SimpleNamespace(learning_rate=lr, learning_rate_bias=2 * lr)
               for lr in (0.1, 0.02)]
        for gd in gds:
            adj.add_gd(gd, mod.make_policy(policy, **kwargs))
        units[pkg] = (adj, gds)

    def rates(pkg):
        adj, gds = units[pkg]
        return adj.iteration, [(g.learning_rate, g.learning_rate_bias)
                               for g in gds]

    for action in (("run", 7), ("restore", 4), ("run", 2), ("restore", 0),
                   ("run", 1), ("restore", 9)):
        for adj, _ in units.values():
            if action[0] == "run":
                for _ in range(action[1]):
                    adj.run()
            else:
                adj.restore_iteration(action[1])
        assert rates("port") == rates("reference"), action
    assert rates("port")[0] == 9
    units["port"][0].restore_iteration(0)
    assert rates("port") == (0, [(0.1, 0.2), (0.02, 0.04)])


def test_an_epoch_is_queued_without_reading_back(tmp_path, monkeypatch):
    """``_dispatch_epoch`` calls no ``item``, ``tolist``, ``cpu``,
    ``numpy``, ``float``, ``int`` or ``bool`` on a tensor: on the card
    the host queues whole epochs without waiting for them."""
    from znicz_torch.parallel.fused import FusedTrainer

    dispatch = FusedTrainer._dispatch_epoch

    def strict(self, keep_input):
        def refuse(name):
            def read(*args, **kwargs):
                raise AssertionError(f"Tensor.{name} inside an epoch")
            return read

        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__float__",
                         "__int__", "__bool__", "__index__"):
                m.setattr(torch.Tensor, name, refuse(name))
            return dispatch(self, keep_input)

    monkeypatch.setattr(FusedTrainer, "_dispatch_epoch", strict)
    with sample_config("mnist", **dict(SEGMENTED["mnist"],
                                       decision__max_epochs=3)):
        t = FusedTrainer(port_sample("mnist", tmp_path))
        assert t.pipeline_depth == 1
        t.pipeline_depth = 2                    # the attribute, as tests set it
        t.run()
    assert t.stats["deep_epochs"] == 3 and bool(t.decision.complete)


@pytest.mark.parametrize("backend,want", [
    ("auto", "cuda"), ("gpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"),
    ("tpu", ValueError), ("metal", ValueError)])
def test_backend_names_the_default_device(backend, want, monkeypatch):
    """``resolve_device(None)`` follows ``backend``: the card, which it
    asks for and never trades for the CPU, or the CPU."""
    from znicz_torch.backends import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with engine(backend=backend):
        if want == "cpu":
            assert resolve_device(None) == torch.device("cpu")
        elif want == "cuda":
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(None)
        else:
            with pytest.raises(ValueError, match="backend"):
                resolve_device(None)
        assert resolve_device("cpu") == torch.device("cpu")


def test_fuse_and_latency_hiding_are_accepted(capsys, monkeypatch):
    """``fuse`` is read nowhere; ``xla_latency_hiding`` warns once a
    process that it has no meaning here."""
    from znicz_torch.core import config
    from znicz_torch.core.config import check_engine_knobs

    monkeypatch.setattr(config, "_warned_latency_hiding", False)
    with engine(fuse=False):
        check_engine_knobs()
    assert capsys.readouterr().err == ""
    with engine(xla_latency_hiding=True):
        check_engine_knobs()
        check_engine_knobs()
    err = capsys.readouterr().err
    assert err.count("xla_latency_hiding") == 1
    assert "no meaning under PyTorch" in err


def test_cli_trains_deep(tmp_path):
    """``python -m znicz_torch mnist --fused`` with ``pipeline_depth`` 3
    gives the finals of the segmented run."""
    over = [f"root.mnist.{k.replace('__', '.')}={v}"
            for k, v in SEGMENTED["mnist"].items()]
    finals = {}
    for depth in (1, 3):
        cmd = [sys.executable, "-m", "znicz_torch", "mnist", "--fused",
               "--device", "cpu", f"root.common.dirs.snapshots={tmp_path}",
               *over, f"root.common.engine.pipeline_depth={depth}"]
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        finals[depth] = json.loads(out.stdout.strip().splitlines()[-1])
    assert finals[3]["train_steps"] == finals[1]["train_steps"] == 19
    assert "deep_epochs" not in finals[1] and finals[3]["deep_epochs"] == 2
    for key in ("final_train_loss", "valid_err_pct"):
        assert finals[3][key] == finals[1][key], key


def test_epoch_hypers_follow_the_reference(tmp_path):
    """An epoch's k + 1 rows, the schedule advanced after the tail's row
    only when the tail's update is applied, as the reference's."""
    from test_torch_segments import _schedule_workflows

    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    cfg = {"loader__n_train": 60, "loader__n_valid": 60, "loader__n_test": 0,
           "loader__minibatch_size": 60}
    with sample_config("mnist", **cfg):
        jwf, twf = _schedule_workflows(tmp_path)
        jt, tt = JTrainer(jwf), FusedTrainer(twf)
        for apply_tail, iteration in ((True, 5), (False, 9)):
            t_rows = tt._epoch_hypers(4, apply_tail)
            j_rows = jt._epoch_hypers(4, apply_tail)
            assert twf.lr_adjust.iteration == jwf.lr_adjust.iteration \
                == iteration
            for name, rows in j_rows.items():
                assert rows.shape == (5, 8)
                np.testing.assert_array_equal(t_rows[name], rows)
