"""The port's segmented run (``FusedTrainer.run``) against the JAX
reference's ``_run_segmented`` on the CPU, and against itself step at a
time.

  - MNIST, and CIFAR10 under ``pallas_lrn`` + ``fused_tail`` (the
    reference's Pallas kernels in interpret mode), with ``scan_chunk`` 8
    in both packages: every TRAIN loss and the final weights within
    ``STEP_TOL``, and the segments of 8 the port formed;
  - ``scan_chunk`` 8 against 1 in the port: losses, weights, velocities
    and the per-class confusions ``torch.equal``;
  - an ``exp`` learning-rate schedule across segment edges
    (``scan_chunk`` 3), the rates after the run;
  - eval segments that stop at the TEST | VALID boundary: the per-class
    confusions equal the reference's;
  - the epoch hook once an epoch, the wall time not counted twice;
  - ``remat`` against no remat in the port (the same bits) and against
    the reference's ``remat``;
  - the per-step hyperparameters as device rows: ``sgd_update`` with
    0-dim float32 tensors gives the bits of float hyperparameters;
  - the eight knobs of this slice, the deep pipeline's four, the
    mesh's three and the snapshot formats' two are read, and with the 30
    refused ones they are the reference's 61;
  - ``remat`` keeps fewer bytes for the backward than no remat.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from test_torch_layers import jax_params, jax_sample, port_sample, \
    sample_config
from test_torch_train import STEP_TOL

_UNSET = object()

#: 10 train minibatches an epoch: a segment of 8, one of 1 and the tail
SEGMENTED = {
    "mnist": {"loader__n_train": 600, "loader__n_valid": 120,
              "loader__n_test": 0, "loader__minibatch_size": 60,
              "decision__max_epochs": 2},
    "cifar": {"loader__n_train": 500, "loader__n_valid": 50,
              "loader__n_test": 0, "loader__minibatch_size": 50,
              "decision__max_epochs": 1},
}
ROUTING = {"mnist": {}, "cifar": {"pallas_lrn": True, "fused_tail": True}}


@contextlib.contextmanager
def engine(**kw):
    """Set ``root.common.engine`` knobs on both packages' trees and put
    the old values back on exit."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    saved = []
    for tree in (troot, jroot):
        for key, val in kw.items():
            saved.append((tree, key, tree.common.engine.get(key, _UNSET)))
            setattr(tree.common.engine, key, val)
    try:
        yield
    finally:
        for tree, key, old in reversed(saved):
            if old is _UNSET:
                delattr(tree.common.engine, key)
            else:
                setattr(tree.common.engine, key, old)


def jax_run(sample, tmp_path, **knobs):
    """(reference workflow, its TRAIN losses) of a seeded run."""
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    with engine(**knobs):
        jwf = jax_sample(sample, tmp_path)
        jt = JTrainer(jwf)
        losses = []
        feed = jt._feed_decision

        def record(mb, metrics):
            if mb["class"] == 2:
                losses.append(float(metrics[0]))
            feed(mb, metrics)

        jt._feed_decision = record
        jt.run()
    return jwf, losses


def port_run(sample, tmp_path, **knobs):
    """The port's trainer after a seeded run of ``sample``."""
    from znicz_torch.parallel.fused import FusedTrainer

    with engine(**knobs):
        twf = port_sample(sample, tmp_path)
        trainer = FusedTrainer(twf)
        trainer.run()
    return trainer


def port_state(trainer):
    """(losses, parameters, velocities, per-class confusions) as tensors."""
    d = trainer.decision
    return (torch.tensor(d.train_losses, dtype=torch.float64),
            {n: {k: p.detach().clone() for k, p in leaves.items()}
             for n, leaves in trainer.extract_params().items()},
            {n: {k: v.clone() for k, v in leaves.items()}
             for n, leaves in trainer.extract_velocities().items()},
            [None if m is None or m.get("confusion") is None
             else m["confusion"].clone() for m in d.epoch_metrics])


def assert_same_bits(a, b):
    la, pa, va, ca = a
    lb, pb, vb, cb = b
    assert torch.equal(la, lb)
    for tree_a, tree_b in ((pa, pb), (va, vb)):
        assert tree_a.keys() == tree_b.keys()
        for name in tree_a:
            for k in tree_a[name]:
                assert torch.equal(tree_a[name][k], tree_b[name][k]), \
                    f"{name}.{k}"
    for x, y in zip(ca, cb):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_segments_match_the_reference(sample, tmp_path):
    """``scan_chunk`` 8 in both packages: the reference scans 8 steps a
    dispatch, the port replays (here: runs) 8 steps a segment."""
    from znicz_torch.weights import params_to_numpy

    with sample_config(sample, **SEGMENTED[sample]):
        jwf, j_losses = jax_run(sample, tmp_path, scan_chunk=8,
                                **ROUTING[sample])
        t = port_run(sample, tmp_path, scan_chunk=8, **ROUTING[sample])
    epochs = SEGMENTED[sample]["decision__max_epochs"]
    assert t.scan_chunk == 8
    assert t.segments[("train", 8)] == epochs
    assert t.segments[("train", 1)] == epochs
    assert t.stats["captured_steps"] == 0            # the CPU runs eagerly
    assert len(t.train_losses) == len(j_losses) == 10 * epochs
    np.testing.assert_allclose(t.train_losses, j_losses, **STEP_TOL)
    got, want = params_to_numpy(t.workflow), jax_params(jwf)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[name][k], v, err_msg=f"{name}.{k}",
                                       **STEP_TOL)
    for klass in (1, 2):
        assert t.decision.epoch_metrics[klass]["n_err"] == \
            jwf.decision.epoch_metrics[klass]["n_err"]


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_scan_chunk_8_is_step_at_a_time_bit_for_bit(sample, tmp_path):
    with sample_config(sample, **SEGMENTED[sample]):
        one = port_run(sample, tmp_path, scan_chunk=1, **ROUTING[sample])
        eight = port_run(sample, tmp_path, scan_chunk=8, **ROUTING[sample])
    assert set(one.segments) == {("train", 1), ("eval", 1)}
    assert ("train", 8) in eight.segments
    assert one.stats["train_steps"] == eight.stats["train_steps"]
    assert_same_bits(port_state(one), port_state(eight))


def _schedule_workflows(tmp_path):
    """The reference's and the port's MNIST layers on a StandardWorkflow
    with an ``exp`` schedule (tests/test_fused.py's LR test)."""
    from znicz_torch.core import prng as tprng
    from znicz_torch.samples import mnist as tmnist
    from znicz_torch.standard_workflow import StandardWorkflow as TWorkflow
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.samples.mnist import MnistLoader as JLoader
    from znicz_tpu.standard_workflow import StandardWorkflow as JWorkflow

    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
               "<-": dict(gd)},
              {"type": "softmax", "->": {"output_sample_shape": 10},
               "<-": dict(gd)}]
    lr = {"policy": "exp", "gamma": 0.9}
    jroot.common.dirs.snapshots = str(tmp_path)
    jprng.reset(1013)
    jwf = JWorkflow(name="MnistStdLR",
                    loader=JLoader(name="loader", minibatch_size=60),
                    layers=layers, loss_function="softmax",
                    decision_config={"max_epochs": 3}, lr_adjust_config=lr)
    jwf.initialize(device=None)
    port_sample("mnist", tmp_path)
    tprng.reset(1013)
    twf = TWorkflow(layers, device="cpu",
                    loader=tmnist.MnistLoader(minibatch_size=60),
                    loss_function="softmax",
                    decision_config={"max_epochs": 3}, lr_adjust_config=lr)
    return jwf, twf


def test_lr_schedule_across_segment_edges(tmp_path):
    """``scan_chunk`` 3 splits each epoch's 4 non-tail steps into
    segments of 3 and 1: the rows advance the schedule step by step, as
    the reference's scan rows do."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_to_numpy
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    cfg = {"loader__n_train": 300, "loader__n_valid": 60, "loader__n_test": 0,
           "loader__minibatch_size": 60}
    with sample_config("mnist", **cfg), engine(scan_chunk=3):
        jwf, twf = _schedule_workflows(tmp_path)
        JTrainer(jwf).run()
        t = FusedTrainer(twf)
        t.run()
    assert t.segments[("train", 3)] == 3 and t.segments[("train", 1)] == 3
    # 3 epochs x 5 updates, less the last tail's: gd_skip gates the
    # update and the schedule alike
    assert jwf.lr_adjust.iteration == twf.lr_adjust.iteration == 14
    for tgd in twf.gds.values():
        assert tgd.learning_rate == pytest.approx(0.1 * 0.9 ** 13, rel=1e-12)
    assert len(twf.decision.train_losses) == 15
    np.testing.assert_allclose(twf.decision.epoch_metrics[2]["loss"],
                               jwf.decision.epoch_metrics[2]["loss"],
                               **STEP_TOL)
    got = params_to_numpy(twf)
    for f in jwf.forwards:
        np.testing.assert_allclose(got[f.name]["weights"],
                                   np.array(f.weights.map_read()),
                                   err_msg=f.name, **STEP_TOL)


def test_lr_schedule_rows_are_the_step_at_a_time_bits(tmp_path):
    from znicz_torch.parallel.fused import FusedTrainer

    cfg = {"loader__n_train": 300, "loader__n_valid": 60, "loader__n_test": 0,
           "loader__minibatch_size": 60}
    states = []
    for chunk in (1, 3):
        with sample_config("mnist", **cfg), engine(scan_chunk=chunk):
            _, twf = _schedule_workflows(tmp_path)
            t = FusedTrainer(twf)
            t.run()
        states.append(port_state(t))
    assert_same_bits(*states)


def test_eval_segments_respect_the_class_boundary(tmp_path):
    """TEST and VALID of 2 minibatches each: under ``scan_chunk`` 8 the
    eval segments are 2 long (never 4), and every class's confusion is
    the reference's."""
    cfg = dict(SEGMENTED["mnist"], loader__n_train=300,
               loader__n_test=120)
    with sample_config("mnist", **cfg):
        jwf, _ = jax_run("mnist", tmp_path, scan_chunk=8)
        t = port_run("mnist", tmp_path, scan_chunk=8)
        one = port_run("mnist", tmp_path, scan_chunk=1)
    assert t.segments[("eval", 2)] == 2 * 2 and ("eval", 4) not in t.segments
    for klass in (0, 1, 2):
        want = np.asarray(jwf.decision.epoch_metrics[klass]["confusion"])
        got = t.decision.epoch_metrics[klass]["confusion"].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"class {klass}")
        assert got.sum() > 0
    assert_same_bits(port_state(one), port_state(t))


def test_epoch_hook_fires_once_an_epoch(tmp_path):
    """A train-only run (no TEST or VALID): the snapshotter is asked once
    an epoch, whether it writes in line or in the background."""
    from znicz_torch.parallel.fused import FusedTrainer

    cfg = {"loader__n_train": 300, "loader__n_valid": 0, "loader__n_test": 0,
           "loader__minibatch_size": 60, "decision__max_epochs": 3}
    for async_snapshot in (True, False):
        calls = []
        with sample_config("mnist", **cfg), \
                engine(async_snapshot=async_snapshot):
            wf = port_sample("mnist", tmp_path)
            snap = wf.snapshotter
            snap.run = lambda: calls.append("sync")
            tags_for = snap.tags_for
            snap.tags_for = lambda e, i: (calls.append("async"),
                                          tags_for(e, i))[1]
            FusedTrainer(wf).run()
        assert bool(wf.decision.complete)
        assert calls == ["async" if async_snapshot else "sync"] * 3


def test_wall_time_is_not_counted_twice(tmp_path):
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config("mnist", **SEGMENTED["mnist"]):
        wf = port_sample("mnist", tmp_path)
        t = FusedTrainer(wf)
        t0 = time.perf_counter()
        t.run()
        elapsed = time.perf_counter() - t0
    st = t.stats
    assert 0 < st["wall_s"] <= elapsed
    assert st["images"] == 2 * 600 and st["img_per_sec"] > 0
    assert 0 < st["warm_images"] < st["images"]


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_remat_changes_memory_not_math(sample, tmp_path):
    """``remat`` recomputes the forward chain in the backward: the same
    bits as without it in the port (the masks of the step are the same
    masks), the reference's run within ``STEP_TOL``: its ``remat`` run
    for MNIST; for CIFAR10 its run without, since the reference's
    ``jax.checkpoint`` leaks a tracer from its fused softmax head under
    ``fused_tail`` (``UnexpectedTracerError``)."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config(sample, **SEGMENTED[sample]):
        jwf, j_losses = jax_run(sample, tmp_path, remat=sample == "mnist",
                                **ROUTING[sample])
        plain = port_run(sample, tmp_path, **ROUTING[sample])
        with engine(remat=True, **ROUTING[sample]):
            twf = port_sample(sample, tmp_path)
            remat = FusedTrainer(twf)          # remat=None reads the knob
            assert remat.remat is True
            remat.run()
    assert plain.remat is False
    assert_same_bits(port_state(plain), port_state(remat))
    np.testing.assert_allclose(remat.train_losses, j_losses, **STEP_TOL)


def _held_bytes(trainer):
    """The bytes a train step's forward leaves for its backward: the
    storages autograd saves outside any checkpoint (seen through
    ``saved_tensors_hooks``, which the checkpoints' own hooks hide their
    tensors from) and the inputs the checkpoints keep, each storage once,
    the parameters left out."""
    import torch.utils.checkpoint as cp

    params = [p for f in trainer._weighted()
              for p in trainer._params_of(f).values()]
    own = {p.untyped_storage().data_ptr() for p in params}
    held = {}

    def keep(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            held[st.data_ptr()] = st.nbytes()
        return t

    inner = cp.checkpoint

    def counted(fn, *args, **kw):
        for a in args:
            if isinstance(a, torch.Tensor):
                keep(a)
        return inner(fn, *args, **kw)

    ldr = trainer.loader
    first = ldr.class_lengths[0] + ldr.class_lengths[1]
    idx = np.arange(first, first + ldr.max_minibatch_size)
    data, target = trainer._minibatch(idx)
    cp.checkpoint = counted
    try:
        with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            loss, _ = trainer.loss_and_metrics(data, target, len(idx), 0,
                                               True)
    finally:
        cp.checkpoint = inner
    grads = torch.autograd.grad(loss, params)
    return sum(held.values()), loss.detach(), grads


@pytest.mark.parametrize("sample", ["mnist", "cifar"])
def test_remat_holds_fewer_bytes_for_the_backward(sample, tmp_path):
    """``remat`` checkpoints each block (a module with weights and the
    modules after it without): a train step's forward leaves fewer bytes
    for its backward than without ``remat`` (on CIFAR10 under
    ``pallas_lrn`` + ``fused_tail`` about an eighth), with the same loss
    and gradients, bit for bit."""
    from znicz_torch.parallel.fused import FusedTrainer

    with sample_config(sample, **SEGMENTED[sample]), \
            engine(**ROUTING[sample]):
        twf = port_sample(sample, tmp_path)
        trainer = FusedTrainer(twf)
        trainer._init_velocities()
        assert trainer.blocks()[0][0] == 0
        plain, loss, grads = _held_bytes(trainer)
        trainer.remat = True
        remat, loss_r, grads_r = _held_bytes(trainer)
    assert 0 < remat < plain
    if sample == "cifar":
        assert len(trainer.blocks()) == 5 and remat < plain / 4
    assert torch.equal(loss, loss_r)
    for g, h in zip(grads, grads_r):
        assert torch.equal(g, h)


def test_remat_keeps_the_dropout_masks():
    """A dropout net: the recomputed forward multiplies by the step's own
    masks, so remat gives the bits of the plain step."""
    from test_torch_planner import SAMPLE, tiny_layers

    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.standard_workflow import StandardWorkflow

    def step(remat):
        ldr = FullBatchLoader(minibatch_size=4)
        ldr.original_data = np.random.default_rng(1).normal(
            size=(4,) + SAMPLE).astype(np.float32)
        ldr.original_labels = np.arange(4, dtype=np.int32)
        from znicz_torch.core import prng

        prng.reset(1013)
        wf = StandardWorkflow(tiny_layers(), device="cpu", loader=ldr)
        t = FusedTrainer(wf, remat=remat)
        losses = [t.train_step(np.arange(4), 4, s)[0] for s in range(2)]
        return torch.stack(losses), t.extract_params()

    (la, pa), (lb, pb) = step(False), step(True)
    assert torch.equal(la, lb)
    for name in pa:
        for k in pa[name]:
            assert torch.equal(pa[name][k], pb[name][k]), f"{name}.{k}"


def test_remat_keeps_injected_masks_and_offsets():
    """A net with stochastic pooling and dropout, its masks and offsets
    from an injected ``mask_fn`` and ``offset_fn`` keyed by (step,
    index): under ``remat`` each is drawn again in its block's recompute
    (twice a train step) and gives the bits of the step without it."""
    from test_torch_kinds import stochastic_layers
    from test_torch_planner import SAMPLE

    from znicz_torch.core import prng
    from znicz_torch.dropout import DropoutForward
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.pooling import StochasticPoolingBase
    from znicz_torch.standard_workflow import StandardWorkflow

    layers = stochastic_layers("stochastic_pooling")
    layers.insert(3, {"type": "dropout", "dropout_ratio": 0.5})

    def step(remat):
        calls = []

        def gen(step_, index):
            calls.append((step_, index))
            return torch.Generator().manual_seed(1000 * step_ + index)

        def mask_fn(step_, index, shape, ratio):
            return DropoutForward.make_mask(gen(step_, index), shape, ratio)

        def offset_fn(step_, index, probs):
            return StochasticPoolingBase.sample_offsets(probs,
                                                        gen(step_, index))

        ldr = FullBatchLoader(minibatch_size=4)
        ldr.original_data = np.random.default_rng(1).normal(
            size=(4,) + SAMPLE).astype(np.float32)
        ldr.original_labels = np.arange(4, dtype=np.int32)
        prng.reset(1013)
        wf = StandardWorkflow(layers, device="cpu", loader=ldr)
        t = FusedTrainer(wf, mask_fn=mask_fn, offset_fn=offset_fn,
                         remat=remat)
        losses = [t.train_step(np.arange(4), 4, s)[0] for s in range(2)]
        return torch.stack(losses), t.extract_params(), calls, t

    (la, pa, ca, _), (lb, pb, cb, t) = step(False), step(True)
    assert len(t.blocks()) == 2
    assert ca == [(0, 1), (0, 3), (1, 1), (1, 3)]
    assert cb == ca[:2] * 2 + ca[2:] * 2      # forward, then the recompute
    assert torch.equal(la, lb)
    for name in pa:
        for k in pa[name]:
            assert torch.equal(pa[name][k], pb[name][k]), f"{name}.{k}"


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
def test_sgd_update_takes_device_rows(state):
    """The fused trainer's hyperparameters are 0-dim float32 tensors
    (views of its (k, M, 8) rows): the same bits as float ones, with
    float32 and bf16 velocities, clipping on and off."""
    from znicz_torch.nn_units import sgd_update

    rng = np.random.default_rng(3)
    for lr, wd, l1, mom, clip in ((0.1, 5e-4, 0.3, 0.9, 0.0),
                                  (0.0123456789, 1e-3, 1.0, 0.5, 0.01),
                                  (0.02, 0.0, 0.0, 0.0, 0.05)):
        w, g, v = (torch.from_numpy(rng.normal(size=(33, 17)).astype(
            np.float32)) for _ in range(3))
        v = v.to(state)
        want = sgd_update(w, g, v, lr=lr, weights_decay=wd, l1_vs_l2=l1,
                          momentum=mom, clip=clip)
        row = torch.tensor([lr, wd, l1, mom, clip], dtype=torch.float32)
        for clip_arg in (row[4], clip):
            got = sgd_update(w, g, v, lr=row[0], weights_decay=row[1],
                             l1_vs_l2=row[2], momentum=row[3], clip=clip_arg)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1]) and got[1].dtype == state


def test_hyper_rows_follow_the_reference(tmp_path):
    """``tiled_hypers`` and the (k, 8) rows with a schedule advancing
    between rows, as the reference's ``_hypers_rows``."""
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    cfg = {"loader__n_train": 60, "loader__n_valid": 60, "loader__n_test": 0,
           "loader__minibatch_size": 60}
    with sample_config("mnist", **cfg):
        jwf, twf = _schedule_workflows(tmp_path)
        jt, tt = JTrainer(jwf), FusedTrainer(twf)
        for name, rows in tt.tiled_hypers(3).items():
            np.testing.assert_array_equal(rows, jt.tiled_hypers(3)[name])
        t_rows, j_rows = tt._hypers_rows(5), jt._hypers_rows(5)
    assert twf.lr_adjust.iteration == jwf.lr_adjust.iteration == 5
    for name, rows in j_rows.items():
        assert rows.shape == (5, 8) and rows.dtype == np.float32
        np.testing.assert_array_equal(t_rows[name], rows)
    mat = tt._hyper_matrix(t_rows)
    assert mat.shape == (5, 2, 8)
    for m, f in enumerate(tt._weighted()):
        np.testing.assert_array_equal(mat[:, m], t_rows[f.name])


def test_the_slice_knobs_are_read():
    """The eight knobs of the segmented run, the four of the deep
    pipeline and the compiler, the three of the training mesh
    (``train_shard``, ``mesh.data``, ``mesh.model``), the two of the
    snapshot formats (``snapshot_format``, ``snapshot_sharded``), the 22
    of the master/slave star, the 4 of its relay tree and
    ``seq_parallel`` left ``UNPORTED_ENGINE_KNOBS`` for
    ``ENGINE_DEFAULTS`` (nested as the reference's); with the 3 knobs
    still refused they are the reference's 61."""
    from znicz_torch.core.config import ENGINE_DEFAULTS, UNPORTED_ENGINE_KNOBS
    from znicz_tpu.core.config import ENGINE_DEFAULTS as JDEFAULTS

    def flat(tree, prefix=""):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out.update(flat(val, prefix + key + "."))
            else:
                out[prefix + key] = val
        return out

    ref, read = flat(JDEFAULTS), flat(ENGINE_DEFAULTS)
    assert set(read) | set(UNPORTED_ENGINE_KNOBS) == set(ref)
    assert not set(read) & set(UNPORTED_ENGINE_KNOBS)
    assert len(ref) == 61
    assert len(UNPORTED_ENGINE_KNOBS) == 3 and len(read) == 58
    for key in ("remat", "scan_chunk", "async_snapshot", "prefetch_segments",
                "decode_workers", "stream_budget_mb", "async_staging",
                "staging_donate", "pipeline_depth", "backend", "fuse",
                "xla_latency_hiding", "train_shard", "mesh.data",
                "mesh.model", "snapshot_format", "snapshot_sharded",
                "mode", "master_bind", "master_resume", "slave_endpoint",
                "job_segment", "job_prefetch", "job_timeout_mult",
                "job_deadline", "slave_ttl", "slave_reconnects",
                "slave_backoff_base", "slave_backoff_cap",
                "slave_breaker_failures", "ingress_rate_limit",
                "ingress_rate_burst", "quarantine_norm_mult",
                "master_snapshot_s", "wire_dtype", "wire_compress",
                "min_slaves", "staleness_bound", "staleness_weight",
                "tree_fanout", "relay_flush_s", "relay_child_ttl",
                "elastic_rehome", "seq_parallel"):
        assert key in read and key not in UNPORTED_ENGINE_KNOBS
        assert read[key] == ref[key], key
