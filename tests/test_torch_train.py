"""The port's training path against the JAX reference on the CPU.

  - data and order: ``tinyimages`` and the loader's index sequence over
    two epochs are bit-equal to the reference's (same named numpy
    streams);
  - the update rule: ``sgd_update`` with decay, the L1/L2 mix, clipping
    and momentum, against the reference's;
  - weights both ways: reference tree -> port -> numpy gives the same
    bits;
  - single train steps: the tiny AlexNet of ``test_torch_planner``, the
    reference's dropout masks injected, three steps under knobs off,
    ``fused`` and ``pallas_lrn``; losses and parameters after the steps
    within rtol 1e-4 / atol 1e-5 of the reference ``FusedTrainer``'s train
    step (the two libraries' convolutions and products sum in different
    orders);
  - end to end: ``FusedTrainer.run`` on the reference's 19x19 tiny
    AlexStyle workflow; the port's epoch losses within rtol 1e-3 of the
    reference's, and falling.
"""

import numpy as np
import pytest
import torch

from test_torch_planner import SAMPLE, jax_workflow, knobs, tiny_layers

STEP_TOL = {"rtol": 1e-4, "atol": 1e-5}
ROUTINGS = {"knobs_off": {},
            "fused": {"fused_elementwise": True, "fused_tail": True},
            "pallas_lrn": {"pallas_lrn": True, "fused_tail": True}}


def _reset_both(seed=1013):
    from znicz_torch.core import prng as tprng
    from znicz_tpu.core import prng as jprng

    jprng.reset(seed)
    tprng.reset(seed)


# -- data and order ------------------------------------------------------------


def test_tinyimages_bit_equal():
    from znicz_torch import datasets as tdata
    from znicz_tpu import datasets as jdata

    _reset_both()
    jd, jl = jdata.tinyimages(12, size=19)
    td, tl = tdata.tinyimages(12, size=19)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)


def _index_sequence(loader, steps):
    seq = []
    for _ in range(steps):
        loader.run()
        seq.append((np.array(getattr(loader.minibatch_indices, "mem",
                                     loader.minibatch_indices)).tolist(),
                    int(loader.minibatch_class), int(loader.minibatch_size),
                    bool(loader.last_minibatch), bool(loader.class_ended),
                    int(loader.epoch_number)))
    return seq


def test_loader_index_sequence_bit_equal_over_two_epochs():
    from znicz_torch.loader.fullbatch import FullBatchLoader as TLoader
    from znicz_tpu.loader.fullbatch import FullBatchLoader as JLoader

    data = np.zeros((23, 2), np.float32)
    labels = np.arange(23, dtype=np.int32) % 3
    _reset_both()
    jl = JLoader(name="loader", minibatch_size=4)
    jl.original_data.mem = data
    jl.original_labels.mem = labels
    jl.class_lengths = [3, 6, 14]
    jl.initialize(device=None)
    jl.indices_only = True
    tl = TLoader(name="loader", minibatch_size=4)
    tl.original_data, tl.original_labels = data, labels
    tl.class_lengths = [3, 6, 14]
    tl.initialize("cpu")
    # an epoch: 1 test + 2 valid + 4 train minibatches
    want = _index_sequence(jl, 14)
    got = _index_sequence(tl, 14)
    assert got == want
    assert [s[1] for s in got[:7]] == [0, 1, 1, 2, 2, 2, 2]
    tail = got[6]                              # 2 valid rows, 2 padded
    assert tail[2] == 2 and tail[3] and tail[0][2:] == [tail[0][1]] * 2
    assert got[13][3] and got[13][5] == 1
    assert got[10][0] != got[3][0]             # TRAIN reshuffled


# -- the update rule -----------------------------------------------------------


@pytest.mark.parametrize("wd,l1,clip,mom", [
    (0.0, 0.0, 0.0, 0.0), (0.0005, 0.0, 0.0, 0.9), (0.01, 0.3, 0.0, 0.5),
    (0.001, 1.0, 0.05, 0.9)])
def test_sgd_update_matches_reference(wd, l1, clip, mom):
    import jax.numpy as jnp

    from znicz_torch.nn_units import sgd_update
    from znicz_tpu.nn_units import sgd_update as jax_sgd

    rng = np.random.default_rng(3)
    w, g, v = (rng.normal(size=(5, 7)).astype(np.float32) * s
               for s in (0.5, 0.2, 0.05))
    f = np.float32
    hyp = dict(lr=f(0.01), weights_decay=f(wd), l1_vs_l2=f(l1),
               momentum=f(mom), clip=f(clip))
    jw, jv = jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(v), **hyp)
    tw, tv = sgd_update(torch.from_numpy(w), torch.from_numpy(g),
                        torch.from_numpy(v), **hyp)
    # elementwise float32 arithmetic in the same order
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-8)


def test_gd_hyper_defaults_follow_the_reference():
    from znicz_torch.nn_units import GradientDescent

    gd = GradientDescent("f", learning_rate=0.02, gradient_moment=0.8,
                         weights_decay=0.1)
    assert gd.hypers() == tuple(np.float32(v) for v in
                                (0.02, 0.02, 0.1, 0.0, 0.0, 0.8, 0.8, 0.0))


# -- weights both ways ---------------------------------------------------------


@pytest.fixture(scope="module")
def reference_state():
    """(reference workflow, params tree, velocities tree) as numpy, the
    velocities made random so the round trip carries real values."""
    from znicz_tpu.parallel.fused import FusedTrainer

    wf = jax_workflow(tiny_layers())
    t = FusedTrainer(wf)
    params = {n: {k: np.asarray(v) for k, v in leaves.items()}
              for n, leaves in t.extract_params().items()}
    rng = np.random.default_rng(11)
    vels = {n: {k: rng.normal(size=np.shape(v)).astype(np.float32)
                for k, v in leaves.items()}
            for n, leaves in t.extract_velocities().items()}
    return wf, params, vels


def test_weights_round_trip_bit_equal(reference_state):
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import (params_from_jax, params_to_numpy,
                                     velocities_from_jax,
                                     velocities_to_numpy)

    _, params, vels = reference_state
    twf = StandardWorkflow(tiny_layers(), SAMPLE, device="cpu")
    params_from_jax(params, twf)
    velocities_from_jax(vels, twf)
    for tree, back in ((params, params_to_numpy(twf)),
                       (vels, velocities_to_numpy(twf))):
        assert set(back) == set(tree)
        for name, leaves in tree.items():
            assert set(back[name]) == set(leaves)
            for k, v in leaves.items():
                np.testing.assert_array_equal(back[name][k], v)
    bad = {n: dict(l) for n, l in vels.items()}
    first = next(iter(bad))
    bad[first]["weights"] = bad[first]["weights"][..., :1]
    with pytest.raises(ValueError, match="shape"):
        velocities_from_jax(bad, twf)
    with pytest.raises(KeyError):
        velocities_from_jax({first: vels[first]}, twf)


# -- single train steps --------------------------------------------------------


STEP_GD = {"learning_rate": 0.05, "gradient_moment": 0.9,
           "weights_decay": 0.0005}
#: (index row, valid rows) per step: the last step is a short minibatch
STEPS = [([3, 1, 4, 0, 5, 2, 7, 6], 8), ([6, 2, 0, 7, 1, 5, 3, 4], 8),
         ([5, 0, 2, 6, 7, 7, 7, 7], 5)]


def _jax_masks():
    """The reference's dropout masks, as the port's mask seam wants them:
    ``make_mask(fold_in(fold_in(base, step), index), ...)``."""
    import jax

    from znicz_tpu.core import prng as jprng
    from znicz_tpu.dropout import DropoutForward

    base = jprng.get("fused_trainer").jax_base_key()

    def mask(step, index, shape, ratio):
        key = jax.random.fold_in(jax.random.fold_in(base, step), index)
        return torch.from_numpy(np.array(
            DropoutForward.make_mask(key, tuple(shape), ratio)))

    return mask


def _port_workflow(jwf, layers, **kw):
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.standard_workflow import StandardWorkflow

    ldr = FullBatchLoader(minibatch_size=jwf.loader.max_minibatch_size)
    ldr.original_data = np.array(jwf.loader.original_data.mem)
    ldr.original_labels = np.array(jwf.loader.original_labels.mem)
    ldr.class_lengths = list(jwf.loader.class_lengths)
    return StandardWorkflow(layers, device="cpu", loader=ldr, **kw)


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_train_steps_match_reference(routing):
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.weights import params_from_jax, params_to_numpy
    from znicz_tpu.core import prng as jprng
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    layers = tiny_layers(gd=STEP_GD)
    jwf = jax_workflow(layers)
    jt = JTrainer(jwf)
    params, vels, dataset, targets, _ = jt._device_state()
    start = {n: {k: np.asarray(v) for k, v in l.items()}
             for n, l in params.items()}
    twf = params_from_jax(start, _port_workflow(jwf, layers))
    tt = FusedTrainer(twf, mask_fn=_jax_masks())
    assert tt.hypers() == jt.hypers()
    with knobs(**ROUTINGS[routing]):
        step_fn = jt.make_train_step()
        for step, (idx, bs) in enumerate(STEPS):
            key = jprng.get("fused_trainer").jax_key(step)
            params, vels, (jloss, _, _) = step_fn(
                params, vels, jt.hypers(), dataset, targets,
                np.array(idx, np.int32), np.int32(bs), key)
            tloss, _, _ = tt.train_step(np.array(idx), bs, step)
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       **STEP_TOL)
    got = params_to_numpy(twf)
    for name, leaves in params.items():
        for k, v in leaves.items():
            assert not np.array_equal(start[name][k], np.asarray(v))
            np.testing.assert_allclose(got[name][k], np.asarray(v),
                                       err_msg=f"{name}.{k}", **STEP_TOL)


def test_train_step_counts_no_kernel_launch_on_the_cpu():
    """On CPU tensors every stage takes its plain version: the kernel
    counters stay put through a fused train step."""
    from znicz_torch.fused_block import (bias_relu_bwd, bias_relu_fwd,
                                         fused_block_bwd, fused_block_fwd)
    from znicz_torch.ops.lrn import lrn_bwd, lrn_fwd
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.loader.fullbatch import FullBatchLoader

    counters = (fused_block_fwd, fused_block_bwd, bias_relu_fwd,
                bias_relu_bwd, lrn_fwd, lrn_bwd)
    before = [c.launches for c in counters]
    ldr = FullBatchLoader(minibatch_size=4)
    ldr.original_data = np.random.default_rng(1).normal(
        size=(4,) + SAMPLE).astype(np.float32)
    ldr.original_labels = np.arange(4, dtype=np.int32)
    twf = StandardWorkflow(tiny_layers(), device="cpu", loader=ldr)
    t = FusedTrainer(twf)
    with knobs(fused_elementwise=True, fused_tail=True):
        loss, n_err, conf = t.train_step(np.arange(4), 4, 0)
    assert np.isfinite(float(loss)) and conf.shape == (10, 10)
    assert int(conf.sum()) == 4 and t.stats["train_steps"] == 1
    assert [c.launches for c in counters] == before


# -- run() end to end ----------------------------------------------------------


def _alexstyle_port(jwf):
    """The port's twin of ``test_fused_block_pallas._tiny_alexstyle_
    workflow``: its own loader regenerates the same 19x19 textures from the
    same named stream; the reference's initial parameters are carried in."""
    from znicz_torch import datasets
    from znicz_torch.core import prng
    from znicz_torch.loader.fullbatch import FullBatchLoader
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_torch.weights import params_from_jax

    prng.reset(1013)

    class _Loader(FullBatchLoader):
        def load_data(self):
            self.original_data, self.original_labels = \
                datasets.tinyimages(260, size=19)
            self.class_lengths = [0, 60, 200]
            super().load_data()

    twf = StandardWorkflow(
        jwf.layers_config, device="cpu",
        loader=_Loader(minibatch_size=jwf.loader.max_minibatch_size),
        decision_config={"max_epochs": jwf.decision.max_epochs,
                         "fail_iterations": 0})
    np.testing.assert_array_equal(twf.loader.original_data,
                                  np.asarray(jwf.loader.original_data.mem))
    tree = {f.name: {k: np.array(a.map_read()) for k, a in f.params().items()}
            for f in jwf.forwards if f.has_weights}
    return params_from_jax(tree, twf)


def test_run_end_to_end_matches_reference(tmp_path):
    from test_fused_block_pallas import _tiny_alexstyle_workflow

    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.parallel.fused import FusedTrainer as JTrainer

    jroot.common.dirs.snapshots = str(tmp_path)
    jwf = _tiny_alexstyle_workflow()
    twf = _alexstyle_port(jwf)
    j_losses, t_losses = [], []
    jwf.decision.on_epoch_end.append(
        lambda d: j_losses.append(d.epoch_metrics[2]["loss"]))
    twf.decision.on_epoch_end.append(
        lambda d: t_losses.append(d.epoch_metrics[2]["loss"]))
    JTrainer(jwf).run()
    t = FusedTrainer(twf)
    t.run()
    assert len(t_losses) == len(j_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    assert t_losses[-1] < t_losses[0], t_losses
    assert twf.decision.complete and t.stats["train_steps"] == 7
    j_err = jwf.decision.epoch_metrics[1]["err_pct"]
    assert abs(twf.decision.epoch_metrics[1]["err_pct"] - j_err) <= 2.0
