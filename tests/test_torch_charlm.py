"""charlm (``znicz_torch/samples/charlm.py``) against the reference's on
the CPU, and the cases of the reference's ``tests/test_charlm.py``:

  - ``make_corpus`` bit for bit, and the seeded workflow (data, labels,
    every initial parameter under the reference's names, the star's
    digest) equal to the reference's;
  - fused train steps from the reference's parameters: losses to
    ``STEP_TOL`` and the parameters and velocities after each step to
    ``STEP_TOL`` (float32, composed and under ``fused_tail``); in bf16 the
    losses to ``BF16_LOSS_RTOL``;
  - ``EvaluatorSeqSoftmax`` against the reference's ``compute_seq``;
  - two fused epochs from the same seed against the reference's two,
    within the reference's fused-tail parity band (``PARITY_TOL``: rtol
    5e-3, atol 5e-4);
  - the reference's cases: the seeded convergence band, fused-tail
    parity with ``seq_epilogue`` in the plan, the unit engine, a
    snapshot served on the 2-D ladder, master/slave on the port's star,
    and the CLI (solo and ``--serve``).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_bf16 import LOSS_RTOL as BF16_LOSS_RTOL
from test_torch_bf16 import dtype_knobs
from test_torch_layers import sample_config
from test_torch_planner import knobs
from test_torch_train import STEP_TOL

REPO = pathlib.Path(__file__).resolve().parent.parent
#: two fused epochs of the two packages, and fused_tail on against off
PARITY_TOL = {"rtol": 5e-3, "atol": 5e-4}
#: the reference's reduced charlm (``tests/test_charlm.py``)
TINY = {"loader__n_train": 384, "loader__n_valid": 48, "loader__n_test": 0,
        "loader__seq_len": 32, "loader__minibatch_size": 32,
        "model__vocab": 32, "model__embed": 48, "model__heads": 2,
        "model__ffn": 96, "learning_rate": 1.0}
#: a smaller one for the step comparisons
STEP_CFG = {**TINY, "loader__n_train": 64, "loader__n_valid": 16,
            "loader__seq_len": 16, "loader__minibatch_size": 16}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small models: the suite's workers
    share the cores, and many threads a worker only spin against each
    other (alone, one thread runs these tests as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tmp_path, cfg=TINY, max_epochs=2):
    """The port's charlm on the CPU from seed 1013, snapshots into
    ``tmp_path``."""
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples.charlm import CharLMWorkflow

    root.common.dirs.snapshots = str(tmp_path)
    with sample_config("charlm", **cfg, decision__max_epochs=max_epochs):
        prng.reset(1013)
        return CharLMWorkflow(device="cpu")


def _reference(tmp_path, cfg=TINY, max_epochs=2):
    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root
    from znicz_tpu.samples.charlm import CharLMWorkflow

    root.common.dirs.snapshots = str(tmp_path)
    with sample_config("charlm", **cfg, decision__max_epochs=max_epochs):
        prng.reset(1013)
        wf = CharLMWorkflow()
        wf.initialize(device=None)
    wf.snapshotter.directory = str(tmp_path)
    return wf


def _ref_params(wf):
    return {f.name: {k: np.array(a.map_read())
                     for k, a in f.params().items()}
            for f in wf.forwards}


def _train(wf, fused, tail=False):
    from znicz_torch.samples import train

    with knobs(fused_tail=tail):
        return train(wf, "charlm", fused=fused)


# -- the data and the start ----------------------------------------------------


@pytest.mark.parametrize("n,vocab,seed", [(100, 32, 1013), (1000, 7, 5),
                                          (31, 256, 0)])
def test_make_corpus_is_the_reference_stream(n, vocab, seed):
    from znicz_torch.samples.charlm import PAD_ID, make_corpus
    from znicz_tpu.samples.charlm import make_corpus as jcorpus

    got = make_corpus(n, vocab, seed)
    assert got.dtype == np.uint8 and got.shape == (n + 1,)
    np.testing.assert_array_equal(got, jcorpus(n, vocab, seed))
    assert got.min() > PAD_ID and got.max() <= vocab - 1


def test_charlm_starts_bit_equal(tmp_path):
    from znicz_torch.network_common import workflow_digest
    from znicz_torch.weights import params_to_numpy
    from znicz_tpu.network_common import workflow_digest as jdigest

    jwf = _reference(tmp_path / "j", STEP_CFG)
    twf = _port(tmp_path / "t", STEP_CFG)
    np.testing.assert_array_equal(twf.loader.original_data,
                                  np.asarray(jwf.loader.original_data.mem))
    np.testing.assert_array_equal(
        twf.loader.original_labels,
        np.asarray(jwf.loader.original_labels.mem))
    assert twf.loader.class_lengths == list(jwf.loader.class_lengths)
    assert twf.sample_shape == (16,) and twf.serving_seq_len == 16
    want, got = _ref_params(jwf), params_to_numpy(twf)
    assert list(got) == list(want) == ["embed", "mha", "ffn", "head"]
    for name, leaves in want.items():
        assert sorted(got[name]) == sorted(leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[name][k], v,
                                          err_msg=f"{name}.{k}")
    assert workflow_digest(twf) == jdigest(jwf)


# -- the fused step ------------------------------------------------------------

#: (index row, batch size) of each step: a full minibatch and a tail
STEPS = [(list(range(16, 32)), 16), (list(range(40, 56)), 16),
         (list(range(60, 64)) + [0] * 12, 4)]


@pytest.mark.parametrize("routing", ["float32", "fused_tail", "bf16"])
def test_fused_steps_match_the_reference(routing, tmp_path):
    """Three fused train steps of both packages from the reference's
    parameters: the losses, and in float32 the parameters and velocities
    (``-lr * grad`` at the first step) after each."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import (params_from_jax, params_to_numpy,
                                     velocities_to_numpy)
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    jwf = _reference(tmp_path / "j", STEP_CFG)
    twf = _port(tmp_path / "t", STEP_CFG)
    dtype = {"compute_dtype": "bf16"} if routing == "bf16" else {}
    with dtype_knobs(**dtype), knobs(fused_tail=routing == "fused_tail"):
        jt = JTrainer(jwf)
        params, vels, dataset, targets, _ = jt._device_state()
        params_from_jax({n: {k: np.asarray(v) for k, v in leaves.items()}
                         for n, leaves in params.items()}, twf)
        tt = FusedTrainer(twf)
        step_fn = jt.make_train_step()
        for step, (idx, bs) in enumerate(STEPS):
            key = jprng.get("fused_trainer").jax_key(step)
            params, vels, (jloss, jerr, _) = step_fn(
                params, vels, jt.hypers(), dataset, targets,
                np.array(idx, np.int32), np.int32(bs), key)
            tloss, terr, _ = tt.train_step(np.array(idx), bs, step)
            if routing == "bf16":
                np.testing.assert_allclose(float(tloss), float(jloss),
                                           rtol=BF16_LOSS_RTOL)
                continue
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       **STEP_TOL)
            assert int(terr) == int(jerr)
            got_p, got_v = params_to_numpy(twf), velocities_to_numpy(twf)
            for name, leaves in params.items():
                for k, v in leaves.items():
                    np.testing.assert_allclose(
                        got_p[name][k], np.asarray(v), err_msg=f"{name}.{k}",
                        **STEP_TOL)
                    np.testing.assert_allclose(
                        got_v[name][k], np.asarray(vels[name][k]),
                        err_msg=f"v {name}.{k}", **STEP_TOL)


def test_evaluator_seq_softmax_matches_compute_seq():
    import jax.numpy as jnp

    from znicz_torch.evaluator import EvaluatorSeqSoftmax
    from znicz_torch.memory import Array
    from znicz_tpu.evaluator import EvaluatorSeqSoftmax as JEval

    rng = np.random.default_rng(91)
    n, t, v, bs = 4, 5, 7, 3
    logits = rng.normal(size=(n, t, v)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, v, size=(n, t))
    err, n_err, loss, _, mes = JEval.compute_seq(
        jnp.asarray(probs), jnp.asarray(labels), np.int32(bs), v, False)
    ev = EvaluatorSeqSoftmax(None, n_classes=v)
    assert ev.compute_confusion is False
    ev.output = Array(probs)
    ev.labels = Array(labels.astype(np.int64))
    ev.batch_size = bs
    ev.initialize(device=torch.device("cpu"))
    ev.run()
    np.testing.assert_allclose(_np(ev.err_output.devmem), np.asarray(err),
                               rtol=1e-6, atol=1e-7)
    assert ev.n_err == int(n_err)
    np.testing.assert_allclose(ev.loss, float(loss), rtol=1e-6)
    np.testing.assert_allclose(ev.max_err_output_sum, float(mes), rtol=1e-6)
    assert _np(ev.confusion_matrix.devmem).shape == (1, 1)


# -- whole runs ----------------------------------------------------------------


def test_two_fused_epochs_match_the_reference(tmp_path):
    """Two fused epochs of both packages from seed 1013: the TRAIN losses
    and the parameters within the reference's fused-tail parity band."""
    from test_torch_engine import _record_train_losses
    from znicz_torch.weights import params_to_numpy
    from znicz_tpu.engine import train as jtrain
    from znicz_tpu.core.config import root as jroot

    jwf = _reference(tmp_path / "j")
    losses = _record_train_losses(jwf.decision)
    jroot.common.engine.fused = True
    try:
        jtrain(jwf)
    finally:
        jroot.common.engine.fused = False
    twf = _train(_port(tmp_path / "t"), fused=True)
    assert len(twf.decision.train_losses) == len(losses) == 2 * 12
    np.testing.assert_allclose(twf.decision.train_losses, losses,
                               **PARITY_TOL)
    got, want = params_to_numpy(twf), _ref_params(jwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v,
                                       err_msg=f"{name}.{k}", **PARITY_TOL)


def test_charlm_fused_converges_seeded_band(tmp_path):
    """The reference's acceptance band: 8 fused epochs bring the VALID
    token error under 50% (random is ~97% at vocab 32: the corpus needs
    context, so the attention layer carries it)."""
    wf = _train(_port(tmp_path, max_epochs=8), fused=True)
    dec = wf.decision
    assert bool(dec.complete)
    err = dec.epoch_metrics[1]["n_err"] / (48 * 32) * 100.0
    assert err < 50.0, (err, dec.epoch_metrics[1])


def test_charlm_fused_tail_parity(tmp_path):
    """``fused_tail`` (the FFN's seq epilogue and the fused loss head)
    against the composed path over two epochs: the same VALID errors
    within 5%, the parameters within ``PARITY_TOL``, and the plan holds
    the seq epilogue."""
    from znicz_torch.fused_block import plan_fused_tail
    from znicz_torch.weights import params_to_numpy

    off = _train(_port(tmp_path / "off"), fused=True)
    on = _train(_port(tmp_path / "on"), fused=True, tail=True)
    assert on.decision.epoch_metrics[1]["n_err"] == pytest.approx(
        off.decision.epoch_metrics[1]["n_err"], rel=0.05)
    p_off, p_on = params_to_numpy(off), params_to_numpy(on)
    for name, leaves in p_off.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(p_on[name][k], v,
                                       err_msg=f"{name}.{k}", **PARITY_TOL)
    with knobs(fused_tail=True):
        plan = plan_fused_tail(on.forwards)
    assert {i: spec.kind for i, spec in plan.items()} == {2: "seq_epilogue"}


def test_charlm_unit_engine_matches_fused_direction(tmp_path):
    """The unit-at-a-time engine trains the same graph: the first TRAIN
    losses equal the reference unit engine's, and six epochs bring the
    VALID token error under 60%."""
    from test_torch_engine import _record_train_losses
    from znicz_tpu.engine import train as jtrain

    jwf = _reference(tmp_path / "j", max_epochs=1)
    losses = _record_train_losses(jwf.decision)
    jtrain(jwf)
    wf = _train(_port(tmp_path / "t", max_epochs=6), fused=False)
    assert not hasattr(wf, "trainer")
    np.testing.assert_allclose(wf.decision.train_losses[:len(losses)],
                               losses, rtol=1e-4)
    dec = wf.decision
    assert bool(dec.complete)
    assert dec.epoch_metrics[1]["n_err"] < 0.60 * 48 * 32


def test_charlm_snapshot_serves_variable_length(tmp_path):
    """A trained snapshot loads for inference like any other, and the
    service runs the 2-D ladder the workflow declares: variable-length
    requests answered ``(n, len, vocab)`` with no family entry after the
    warmup, a probe's rows bit-equal whatever its same-rung neighbour."""
    from znicz_torch import snapshotter
    from znicz_torch.serving import InferenceClient, InferenceServer
    from znicz_torch.weights import params_to_numpy

    wf = _train(_port(tmp_path, max_epochs=1), fused=True)
    path = wf.snapshotter.save("charlm_serve_test")
    trained = params_to_numpy(wf)
    fresh = _port(tmp_path / "fresh")
    meta = snapshotter.load_inference(fresh, path)
    assert "units" not in meta
    got = params_to_numpy(fresh)
    for name, leaves in trained.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[name][k], v)
    srv = InferenceServer(fresh, max_batch=4, max_delay_ms=2.0).start()
    cli = InferenceClient(srv.endpoint, timeout=60)
    try:
        ladder = srv.batcher.ladder
        assert ladder.seq_rungs[-1] == 32
        warm = srv.runner.compiles
        assert warm == len(ladder.buckets())
        rng = np.random.default_rng(5)
        for L in (3, 9, 17, 32, 5):
            y = cli.infer(rng.integers(1, 32, size=(2, L)).astype(np.uint8))
            assert y.shape == (2, L, 32) and np.all(np.isfinite(y))
        assert srv.runner.compiles == warm
        probe = rng.integers(1, 32, size=(2, 10)).astype(np.uint8)
        replies = []
        for fill_len in (9, 12, 16):
            fill = rng.integers(1, 32, size=(2, fill_len)).astype(np.uint8)
            rid_p, rid_f = cli.submit(probe), cli.submit(fill)
            reps = {}
            while len(reps) < 2:
                for rep in cli.collect(0.05):
                    reps[rep["req_id"]] = rep
            assert reps[rid_p].get("ok") and reps[rid_f].get("ok")
            replies.append(reps[rid_p]["y"])
        # rows rung 4 each time (2 + 2 rows): one bucket, bit-equal
        assert all(np.array_equal(replies[0], y) for y in replies[1:])
        stats = srv.batcher.stats()
        assert stats["real_cells"] > 0 and isinstance(stats["pad_ratio"],
                                                      dict)
    finally:
        cli.close()
        srv.stop()


def test_charlm_master_slave_trains(tmp_path):
    """The star needs nothing new: a charlm master serves jobs to a
    charlm slave over wire v3, plain tensors for the projections and
    tables, and training completes with the deltas applied (lr 0.3, as
    the reference's case keeps it)."""
    from znicz_torch.client import Client
    from znicz_torch.server import Server

    cfg = {**TINY, "learning_rate": 0.3}
    master_wf = _port(tmp_path / "m", cfg)
    server = Server(master_wf, job_timeout=60.0).start()
    slave = Client(_port(tmp_path / "s", cfg),
                   endpoint=server.endpoint, slave_id="charlm0")
    errors = []

    def work():
        try:
            slave.run()
        except BaseException as exc:       # surfaced by the assert below
            errors.append(repr(exc))

    t = threading.Thread(target=work, daemon=True)
    t.start()
    assert server.join(240)
    t.join(timeout=60)
    assert not errors, errors
    assert not t.is_alive()
    assert bool(master_wf.decision.complete)
    assert server.jobs_done > 0
    assert server.jobs_by_slave.get("charlm0", 0) > 0
    assert server.jobs_ledger()["balanced"]


CLI_TINY = ["root.charlm.loader.n_train=96", "root.charlm.loader.n_valid=32",
            "root.charlm.loader.seq_len=16"]


def test_launcher_charlm_solo_cli(tmp_path, capsys):
    from znicz_torch.__main__ import SAMPLES, main

    assert "charlm" in SAMPLES
    # every key the overrides set is put back after the run
    with sample_config("charlm", loader__minibatch_size=32,
                       loader__n_train=0, loader__n_valid=0,
                       loader__seq_len=0, decision__max_epochs=0):
        assert main(["charlm", "--device", "cpu", *CLI_TINY,
                     "root.charlm.decision.max_epochs=1",
                     f"root.common.dirs.snapshots={tmp_path}"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workflow"] == "charlm" and line["epochs"] == 1
    # three TRAIN minibatches; the last one's update is skipped, as the
    # Decision completes on it
    assert line["train_steps"] == 2
    assert 0.0 <= line["valid_token_err_pct"] <= 100.0
    assert (tmp_path / "charlm_best.pickle.gz").exists()


def test_launcher_charlm_serve_cli(tmp_path):
    """``--serve`` builds the workflow untrained and serves variable-length
    uint8 requests on the 2-D ladder until ``max_requests``."""
    from znicz_torch.serving import InferenceClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", "charlm", "--serve",
         "tcp://127.0.0.1:*", "--device", "cpu", *CLI_TINY,
         "root.common.serving.max_batch=4",
         "root.common.serving.max_requests=2"],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(REPO),
                        "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving charlm at tcp://127.0.0.1:"), \
            line + proc.stderr.read()
        cli = InferenceClient(line.split(" at ")[1].split()[0], timeout=120,
                              resend_after_s=300.0)
        try:
            assert cli.infer(np.ones((2, 5), np.uint8)).shape == (2, 5, 32)
            assert cli.infer(np.ones((1, 16), np.uint8)).shape \
                == (1, 16, 32)
        finally:
            cli.close()
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert '"served": 2' in out.splitlines()[-1]
