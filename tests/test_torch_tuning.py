"""The tuning and misc units (``znicz_torch/rbm.py``, ``misc_units.py``,
``ensemble.py``, ``accelerated_units.py``, ``genetics.py`` and the CLI's
``--fitness``) against the reference's on the CPU:

  - CD-1 steps of ``GradientRBM`` from the reference's state (carried by
    ``params_from_jax``, its ``vbias`` too) with the reference's Bernoulli
    sample injected: weights, biases and reconstruction error within
    float32 (``TOL``); the port's own draws lower the error;
  - ``MeanDispNormalizerUnit``, ``ZeroFiller`` and ``NNRollback`` on the
    same inputs as the reference's;
  - ``EnsembleEvaluator.predict_proba`` on reduced MNIST members trained
    by the reference and carried across, and on a chain of a mean/disp
    normaliser, stochastic pooling, dropout and a softmax head (each in
    eval mode); ``EnsembleTrainer``'s members' metrics;
  - the GA's chromosomes, winner and history equal to the reference's for
    one seed and an in-process fitness; ``SubprocessEvaluator`` over
    ``python -m znicz_torch mnist --fitness``;
  - ``--fitness`` on a reduced MNIST (the reference's value), and exit 3
    with the reference's message where no fitness is finite;
  - ``DeviceBenchmark`` on the CPU and the reference-era aliases.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_layers import sample_config

REPO = pathlib.Path(__file__).resolve().parent.parent
#: float32 agreement of two packages' arithmetic
TOL = {"rtol": 1e-5, "atol": 1e-6}
#: the reference's reduced MNIST (``tests/test_services.py``)
MNIST = {"loader__n_train": 120, "loader__n_valid": 60,
         "loader__minibatch_size": 60, "decision__max_epochs": 1}
MNIST_CLI = ["root.mnist.loader.n_train=120", "root.mnist.loader.n_valid=60",
             "root.mnist.loader.minibatch_size=60",
             "root.mnist.decision.max_epochs=2"]
#: a run whose only metric (TRAIN: no VALID rows) is NaN from its first
#: epoch: no fitness is finite
DIVERGED_CLI = ["mnist_ae", "root.mnist_ae.learning_rate=1e30",
                "root.mnist_ae.loader.n_valid=0",
                "root.mnist_ae.loader.n_train=300",
                "root.mnist_ae.decision.max_epochs=1"]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _cli(package, args, tmp_path):
    """``python -m <package> <args> --fitness`` on the CPU: (rc, stdout,
    stderr)."""
    cmd = [sys.executable, "-m", package, *args,
           f"root.common.dirs.snapshots={tmp_path / package}", "--fitness"]
    if package == "znicz_torch":
        cmd += ["--device", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    return out.returncode, out.stdout, out.stderr


def _fitness(stdout):
    lines = [ln for ln in stdout.strip().splitlines()
             if "genetics_fitness" in ln]
    return json.loads(lines[-1])["genetics_fitness"] if lines else None


# -- rbm -----------------------------------------------------------------------


def _rbm_data(n=64, width=16):
    rng = np.random.default_rng(29)
    protos = (rng.random(size=(2, width)) > 0.5).astype(np.float32)
    data = protos[rng.integers(0, 2, size=n)]
    flip = rng.random(size=data.shape) < 0.05
    return np.abs(data - flip.astype(np.float32))


def _port_rbm(data, lr=0.2):
    """The port's hidden All2AllSigmoid(8) and its GradientRBM in one
    workflow, on the CPU."""
    from znicz_torch.all2all import All2AllSigmoid
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.memory import Array
    from znicz_torch.nn_units import ForwardBase
    from znicz_torch.rbm import GradientRBM

    wf = Workflow(name="rbm")
    mod = All2AllSigmoid(name="rbm_h", output_sample_shape=(8,))
    mod.build(data.shape, torch.device("cpu"))
    hidden = ForwardBase(wf, module=mod)
    gr = GradientRBM(wf, name="rbm_gd", hidden=hidden, learning_rate=lr)
    gr.input = Array(data)
    gr.batch_size = data.shape[0]
    gr.initialize(device="cpu")
    return wf, gr


def test_binarization_draws_bernoulli_and_takes_a_sample():
    from znicz_torch.memory import Array
    from znicz_torch.rbm import Binarization

    p = np.full((100, 20), 0.3, np.float32)
    b = Binarization(name="bin")
    b.input = Array(p)
    b.initialize(device="cpu")
    b.run()
    out = b.output.map_read()
    assert set(np.unique(out)) <= {0.0, 1.0}
    assert 0.25 < out.mean() < 0.35
    b.run()                                  # the next step draws anew
    assert not np.array_equal(b.output.map_read(), out)
    mask = (np.arange(2000).reshape(100, 20) % 3 == 0).astype(np.float32)
    b.sample_fn = lambda step, probs: torch.from_numpy(mask)
    b.run()
    np.testing.assert_array_equal(b.output.map_read(), mask)


def test_rbm_cd1_steps_match_the_reference():
    """Four CD-1 steps (the last on a partial minibatch of 40 valid rows)
    from the reference's initial state, carried across with
    ``params_from_jax`` (the visible bias too), with the reference's
    Bernoulli sample of each step injected: the hidden weights and bias,
    the visible bias and the reconstruction error within float32."""
    import jax
    import jax.numpy as jnp

    from znicz_tpu.all2all import All2AllSigmoid as JSigmoid
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.rbm import GradientRBM as JRBM
    from znicz_torch.weights import params_from_jax, params_to_numpy

    data = _rbm_data()
    hidden = JSigmoid(name="rbm_h", output_sample_shape=(8,))
    hidden.input = JArray(data)
    hidden.initialize(device=None)
    jgr = JRBM(name="rbm_gd", hidden=hidden, learning_rate=0.2)
    jgr.input = JArray(data)
    jgr.batch_size = 64
    jgr.initialize(device=None)

    def state():
        return {"rbm_h": {"weights": np.array(hidden.weights.map_read()),
                          "bias": np.array(hidden.bias.map_read())},
                "rbm_gd": {"vbias": np.array(jgr.vbias.map_read())}}

    wf, gr = _port_rbm(data)
    params_from_jax(state(), wf)
    for step, batch in enumerate((64, 64, 64, 40)):
        jgr.batch_size = gr.batch_size = batch
        before = state()
        w, bh = before["rbm_h"]["weights"], before["rbm_h"]["bias"]
        valid = (np.arange(64) < batch)[:, None].astype(np.float32)
        h0p = jax.nn.sigmoid(jnp.asarray(data * valid) @ w.T + bh) * valid
        h0 = np.asarray(jax.random.bernoulli(
            jprng.get("rbm_gd").jax_key(step), h0p)).astype(np.float32)
        gr.sample_fn = lambda s, p, h0=h0: torch.from_numpy(h0)
        jgr.run()
        gr.run()
        got, want = params_to_numpy(wf), state()
        for name, leaves in want.items():
            for k, v in leaves.items():
                np.testing.assert_allclose(got[name][k], v,
                                           err_msg=f"{step} {name}.{k}",
                                           **TOL)
        np.testing.assert_allclose(gr.reconstruction_error,
                                   jgr.reconstruction_error, **TOL)


def test_rbm_cd1_reduces_reconstruction_error():
    """The reference's case on the port's own draws: 30 CD-1 steps on two
    noisy binary prototypes lower the reconstruction error by 30%."""
    _, gr = _port_rbm(_rbm_data())
    errs = []
    for _ in range(30):
        gr.run()
        errs.append(gr.reconstruction_error)
    assert errs[-1] < errs[0] * 0.7, (errs[0], errs[-1])


# -- misc units ----------------------------------------------------------------


def test_mean_disp_unit_matches_the_reference():
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.misc_units import MeanDispNormalizerUnit as JUnit
    from znicz_torch.memory import Array
    from znicz_torch.misc_units import MeanDispNormalizerUnit

    rng = np.random.default_rng(7)
    x = rng.normal(3.0, 2.0, size=(10, 3, 2)).astype(np.float32)
    flat = x.reshape(10, -1)
    mean, disp = flat.mean(0), flat.max(0) - flat.min(0)
    outs = []
    for unit, arr in ((JUnit(name="mdn"), JArray),
                      (MeanDispNormalizerUnit(name="mdn"), Array)):
        unit.input = arr(x)
        unit.mean.mem, unit.disp.mem = mean, disp
        unit.initialize(device="cpu" if arr is Array else None)
        unit.run()
        outs.append(np.array(unit.output.map_read()))
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(
        outs[1], ((flat - mean) / disp).reshape(x.shape), rtol=1e-5)
    with pytest.raises(ValueError, match="set mean/disp"):
        MeanDispNormalizerUnit(name="bare").initialize(device="cpu")


def test_zero_filler_and_rollback_match_the_reference():
    """The reference's sequence on both packages from the same weights:
    the mask zeroes a row, a good loss is recorded, the weights are
    spoiled, a diverged loss restores them (one rollback), a NaN loss
    with nothing recorded restores nothing."""
    from znicz_tpu.all2all import All2All as JAll2All
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.misc_units import NNRollback as JRollback
    from znicz_tpu.misc_units import ZeroFiller as JZeroFiller
    from znicz_torch.all2all import All2All
    from znicz_torch.misc_units import NNRollback, ZeroFiller

    jf = JAll2All(name="zf_fwd", output_sample_shape=(3,))
    jf.input = JArray(np.ones((2, 4), np.float32))
    jf.initialize(device=None)
    tf = All2All(name="zf_fwd", output_sample_shape=(3,))
    tf.build((2, 4), torch.device("cpu"))
    with torch.no_grad():
        tf.weights.copy_(torch.from_numpy(np.array(jf.weights.map_read())))
    mask = np.ones((3, 4), bool)
    mask[0, :] = False
    mask[2, 1] = False

    def weights():
        return np.array(jf.weights.map_read()), _np(tf.weights)

    for zf_cls, fwd in ((JZeroFiller, jf), (ZeroFiller, tf)):
        zf = zf_cls(name="zf")
        zf.add_mask(fwd, mask)
        zf.run()
    want, got = weights()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[~mask] == 0) and np.all(got[mask] != 0)

    rbs = []
    for rb_cls, fwd in ((JRollback, jf), (NNRollback, tf)):
        rb = rb_cls(name="rb", rollback_factor=2.0)
        rb.watch(fwd)
        rb.loss = 1.0
        rb.run()                              # records the best
        rbs.append(rb)
    good = weights()
    jf.weights.map_write()[...] = 99.0
    with torch.no_grad():
        tf.weights.fill_(99.0)
    for rb in rbs:
        rb.loss = 10.0                        # diverged
        rb.run()
    want, got = weights()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, good[1])
    assert [rb.rollbacks for rb in rbs] == [1, 1]
    assert [rb.best_loss for rb in rbs] == [1.0, 1.0]
    fresh = NNRollback(name="rb2")
    fresh.watch(tf)
    fresh.loss = float("nan")
    fresh.run()
    assert fresh.rollbacks == 0
    with pytest.raises(ValueError, match="mask"):
        ZeroFiller(name="zf2").add_mask(tf, np.ones((4, 3), bool))


# -- ensembles -----------------------------------------------------------------


def _digits(n=20):
    """``n`` digits from the reference's ``dataset.ens`` stream (drawn
    once: the stream moves on)."""
    from znicz_tpu import datasets

    data, labels = datasets.digits(n, stream="dataset.ens")
    return data.reshape(n, -1), labels


@pytest.fixture(scope="module")
def reference_members(tmp_path_factory):
    """Two reduced MNIST members trained by the reference's
    ``EnsembleTrainer`` (seeds 1013 and 2013), and its predictions on 20
    digits."""
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.ensemble import EnsembleEvaluator as JEvaluator
    from znicz_tpu.ensemble import EnsembleTrainer as JTrainer
    from znicz_tpu.samples import mnist as jmnist

    jroot.common.dirs.snapshots = str(tmp_path_factory.mktemp("ens"))

    def factory(seed):
        wf = jmnist.MnistWorkflow()
        wf.initialize(device=None)
        wf.run()
        return wf

    with sample_config("mnist", **MNIST):
        trainer = JTrainer(factory, n_models=2).run()
    data, labels = _digits()
    ev = JEvaluator(trainer.members)
    return (trainer, (data, labels), ev.predict_proba(data),
            ev.n_err(data, labels))


def _ref_params(wf):
    return {f.name: {k: np.array(a.map_read())
                     for k, a in f.params().items()}
            for f in wf.forwards if f.params()}


def test_ensemble_predicts_on_weights_carried_across(reference_members):
    """The reference's members' weights carried into the port's MNIST
    workflows: soft voting gives the reference's probabilities and error
    count; the members differ."""
    from znicz_torch.ensemble import EnsembleEvaluator
    from znicz_torch.samples.mnist import MnistWorkflow
    from znicz_torch.weights import params_from_jax

    trainer, (data, labels), want, want_err = reference_members
    members = []
    with sample_config("mnist", **MNIST):
        for jwf in trainer.members:
            members.append(params_from_jax(_ref_params(jwf),
                                           MnistWorkflow(device="cpu")))
    assert not np.allclose(_np(members[0].forwards[0].weights),
                           _np(members[1].forwards[0].weights))
    ev = EnsembleEvaluator(members)
    got = ev.predict_proba(data)
    assert got.shape == (20, 10)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    assert ev.n_err(data, labels) == want_err


def test_ensemble_trainer_members_match_the_reference(reference_members,
                                                      tmp_path):
    """The port's ``EnsembleTrainer`` over the same factory: each member
    from its seed, their best metrics the reference's members'."""
    from znicz_torch.core.config import root
    from znicz_torch.ensemble import EnsembleTrainer
    from znicz_torch.samples import train
    from znicz_torch.samples.mnist import MnistWorkflow

    root.common.dirs.snapshots = str(tmp_path)
    seeds = []

    def factory(seed):
        seeds.append(seed)
        return train(MnistWorkflow(device="cpu"), "mnist")

    with sample_config("mnist", **MNIST):
        trainer = EnsembleTrainer(factory, n_models=2).run()
    assert seeds == [1013, 2013] and len(trainer.members) == 2
    np.testing.assert_allclose(trainer.metrics, reference_members[0].metrics,
                               atol=1.0 / 60)


def test_ensemble_eval_chain_matches_the_reference():
    """``pure_forward`` over a mean/disp normaliser, stochastic pooling
    (its expectation), dropout (the identity) and a softmax head, the
    head and the normaliser's statistics carried across with
    ``params_from_jax``: the reference's ``pure_forward``'s output."""
    from znicz_tpu.all2all import All2AllSoftmax as JSoftmax
    from znicz_tpu.dropout import DropoutForward as JDropout
    from znicz_tpu.ensemble import EnsembleEvaluator as JEvaluator
    from znicz_tpu.memory import Array as JArray
    from znicz_tpu.misc_units import MeanDispNormalizerUnit as JMeanDisp
    from znicz_tpu.pooling import StochasticPooling as JStochastic
    from znicz_torch.all2all import All2AllSoftmax
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.dropout import DropoutForward
    from znicz_torch.ensemble import EnsembleEvaluator
    from znicz_torch.misc_units import MeanDispNormalizerUnit
    from znicz_torch.nn_units import ForwardBase
    from znicz_torch.pooling import StochasticPooling
    from znicz_torch.weights import params_from_jax

    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, size=(6, 4, 4, 2)).astype(np.float32)
    flat = x.reshape(6, -1)
    mean, disp = flat.mean(0), flat.std(0) + 0.5

    jmd = JMeanDisp(name="mdn")
    jmd.mean.mem, jmd.disp.mem = mean, disp
    jforwards = [jmd, JStochastic(name="pool", kx=2, ky=2),
                 JDropout(name="drop", dropout_ratio=0.5),
                 JSoftmax(name="head", output_sample_shape=(3,))]
    shape = x.shape
    for f in jforwards:
        f.input = JArray(np.zeros(shape, np.float32))
        f.initialize(device=None)
        shape = f.output_shape_for(shape)
    want = np.asarray(JEvaluator.pure_forward(jforwards, x))

    wf = Workflow(name="chain")
    modules = [StochasticPooling(name="pool", kx=2, ky=2),
               DropoutForward(name="drop", dropout_ratio=0.5),
               All2AllSoftmax(name="head", output_sample_shape=(3,))]
    md = MeanDispNormalizerUnit(wf, name="mdn")
    md.mean.mem, md.disp.mem = np.zeros_like(mean), np.ones_like(disp)
    md.initialize(device="cpu")
    shape = x.shape
    for mod in modules:
        shape = mod.build(shape, torch.device("cpu"))
        ForwardBase(wf, module=mod)
    params_from_jax({"mdn": {"mean": mean, "disp": disp},
                     "head": {k: np.array(a.map_read())
                              for k, a in jforwards[-1].params().items()}},
                    wf)
    got = _np(EnsembleEvaluator.pure_forward([md] + modules, x))
    assert got.shape == (6, 3)
    np.testing.assert_allclose(got, want, **TOL)


# -- the genetic search --------------------------------------------------------


def _bowl(cfg, seen):
    def evaluate():
        x, y = float(cfg.model.get("x")), float(cfg.model.get("y"))
        seen.append((x, y))
        return (x - 2.0) ** 2 + (y - 1.0) ** 2
    return evaluate


def test_ga_draws_the_reference_chromosomes():
    """One seed, one in-process fitness: every chromosome scored, the
    winner, its fitness and the history are the reference's, and the
    config is left at the winner."""
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import Config as JConfig
    from znicz_tpu.genetics import GeneticsOptimizer as JOptimizer
    from znicz_tpu.genetics import Tune as JTune
    from znicz_torch.core import prng
    from znicz_torch.core.config import Config
    from znicz_torch.genetics import GeneticsOptimizer, Tune, find_tunes

    runs = []
    for config, tune, optimizer, stream in (
            (JConfig, JTune, JOptimizer, jprng),
            (Config, Tune, GeneticsOptimizer, prng)):
        stream.reset(1013)
        cfg = config("groot")
        cfg.model.x = tune(5.0, -10.0, 10.0)
        cfg.model.y = tune(-3.0, -10.0, 10.0)
        seen = []
        opt = optimizer(_bowl(cfg, seen), cfg, generations=6, population=8)
        best, fitness = opt.run()
        runs.append((seen, list(best), fitness, opt.history,
                     (cfg.model.get("x"), cfg.model.get("y"))))
    assert [p for p, _ in find_tunes(cfg)] == []      # set to the winner
    assert runs[1] == runs[0]
    assert len(runs[0][0]) > 8 and runs[0][2] < 1.0


def test_subprocess_evaluator_tunes_a_reduced_mnist(tmp_path):
    """Two generations of three, two runs at a time, each a ``python -m
    znicz_torch mnist ... --fitness`` on the CPU: finite fitnesses (valid
    error fractions), the learning rate kept in its range, the history
    not worse for elitism."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.genetics import (GeneticsOptimizer, SubprocessEvaluator,
                                      Tune)

    prng.reset(1013)
    cfg = root.ga_mnist_tuning
    cfg.learning_rate = Tune(0.02, 0.005, 0.6)
    evaluator = SubprocessEvaluator(
        "mnist", overrides=MNIST_CLI + [
            f"root.common.dirs.snapshots={tmp_path}", "--device", "cpu"],
        prefix="root.mnist", timeout=300.0)
    assert evaluator.cwd == str(REPO)
    assert evaluator.command({"learning_rate": 0.1})[-2:] == [
        "root.mnist.learning_rate=0.1", "--fitness"]
    opt = GeneticsOptimizer(config_root=cfg, generations=2, population=3,
                            elite=1, workers=2,
                            subprocess_evaluator=evaluator)
    best, fitness = opt.run()
    assert np.isfinite(fitness) and 0.0 <= fitness <= 1.0
    assert 0.005 <= best[0] <= 0.6
    assert len(opt.history) == 2 and opt.history[-1] <= opt.history[0]
    assert opt.max_parallel == 2


def test_fitness_flag_matches_the_reference(tmp_path):
    """``--fitness`` after a reduced MNIST prints the reference's
    ``genetics_fitness`` as the last line; a run with no finite fitness
    exits 3 on both, with the reference's message and no fitness line."""
    rc, out, err = _cli("znicz_torch", ["mnist", *MNIST_CLI], tmp_path)
    assert rc == 0, err[-2000:]
    assert "genetics_fitness" in out.strip().splitlines()[-1]
    jrc, jout, jerr = _cli("znicz_tpu", ["mnist", *MNIST_CLI], tmp_path)
    assert jrc == 0, jerr[-2000:]
    assert _fitness(out) == _fitness(jout)
    for package in ("znicz_torch", "znicz_tpu"):
        rc, out, err = _cli(package, DIVERGED_CLI, tmp_path)
        assert rc == 3, (package, err[-2000:])
        assert "genetics_fitness" not in out
        assert err.strip().splitlines()[-1] == (
            "error: workflow exposes no finite fitness "
            "(decision.best_metric / epoch_qerror)")


# -- the device benchmark ------------------------------------------------------


def test_device_benchmark_on_the_cpu_and_the_aliases():
    from znicz_torch.accelerated_units import (AcceleratedGDUnit,
                                               AcceleratedUnit,
                                               AcceleratedWorkflow,
                                               DeviceBenchmark)
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.nn_units import ForwardBase, GradientDescentBase

    assert AcceleratedUnit is ForwardBase
    assert AcceleratedGDUnit is GradientDescentBase
    assert AcceleratedWorkflow is Workflow
    bench = DeviceBenchmark(size=64, repeats=2)
    results = bench.run()
    assert "cpu" in results and all(t > 0 for t in results.values())
    assert bench.best() == min(results, key=results.get)
