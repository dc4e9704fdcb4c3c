"""The port's fusion planners (znicz_torch/fused_block.py) against the
reference's (znicz_tpu/pallas_fused_block.py) on the same layer lists:
the same start indices and the same specs with the knobs off, on, under
the LRN-formulation opt-outs, and where a pool does not tile its plane.

Also home of the helpers the other port tests share: the tiny
AlexNet-shaped layer list, the reference workflow built from it, and
``knobs``, which sets engine knobs on BOTH packages' config trees (they
are separate objects)."""

import contextlib

import numpy as np
import pytest

SAMPLE = (31, 31, 3)


def tiny_layers(pool1=None, n_classes=10):
    """AlexNet's shape at toy widths on a 31x31x3 input: conv1 3x3/s2 ->
    15x15 and conv2 -> 7x7, both pooled 3x3/s2 exactly; conv3-5 at 3x3;
    a final exactly tiling pool to 1x1; fc6/fc7 with dropout; softmax.
    conv2 has an odd channel count (13)."""
    gd = {"learning_rate": 0.01}
    return [
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 8, "kx": 3, "ky": 3, "sliding": (2, 2)},
         "<-": dict(gd)},
        {"type": "norm"},
        {"type": "max_pooling",
         "->": pool1 or {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 13, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "norm"},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "conv_strict_relu",
         "->": {"n_kernels": 12, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
         "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "all2all_strict_relu", "->": {"output_sample_shape": 32},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_strict_relu", "->": {"output_sample_shape": 24},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


def jax_workflow(layers, sample_shape=SAMPLE, n=8, bias_seed=7):
    """The reference StandardWorkflow of ``layers`` on a random dataset,
    initialised; its biases are made random (seeded) so the bias paths
    are exercised."""
    from znicz_tpu.core import prng
    from znicz_tpu.loader.fullbatch import FullBatchLoader
    from znicz_tpu.standard_workflow import StandardWorkflow

    prng.reset(1013)

    class _Loader(FullBatchLoader):
        def load_data(self):
            rng = np.random.default_rng(5)
            self.original_data.mem = rng.normal(
                size=(n,) + tuple(sample_shape)).astype(np.float32)
            self.original_labels.mem = (np.arange(n) % 10).astype(np.int32)
            self.class_lengths = [0, 0, n]
            super().load_data()

    wf = StandardWorkflow(
        name="TinyAlexNet", loader=_Loader(name="loader", minibatch_size=n),
        layers=layers, loss_function="softmax",
        decision_config={"max_epochs": 1, "fail_iterations": 0})
    wf.initialize(device=None)
    rng = np.random.default_rng(bias_seed)
    for f in wf.forwards:
        if f.has_weights:
            b = f.bias.map_write()
            b[...] = rng.normal(scale=0.1, size=b.shape).astype(np.float32)
    return wf


@contextlib.contextmanager
def knobs(**kw):
    """Set ``root.common.engine`` knobs on both packages' trees; reset
    them to False on exit."""
    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    for r in (jroot, troot):
        for key, val in kw.items():
            setattr(r.common.engine, key, val)
    try:
        yield
    finally:
        for r in (jroot, troot):
            for key in kw:
                setattr(r.common.engine, key, False)


def _plans(layers):
    from znicz_torch.fused_block import plan_fused_blocks as t_blocks
    from znicz_torch.fused_block import plan_fused_tail as t_tail
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_tpu.pallas_fused_block import plan_fused_blocks as j_blocks
    from znicz_tpu.pallas_fused_block import plan_fused_tail as j_tail

    jwf = jax_workflow(layers)
    twf = StandardWorkflow(layers, SAMPLE, device="cpu")
    out = []
    for blocks, tail, fwds in ((j_blocks, j_tail, jwf.forwards),
                               (t_blocks, t_tail, list(twf.forwards))):
        bp = blocks(fwds)
        out.append(({i: tuple(s) for i, s in bp.items()},
                    {i: tuple(s) for i, s in tail(fwds, bp).items()}))
    return out


def test_unit_names_match_the_reference():
    from znicz_torch.standard_workflow import StandardWorkflow

    jwf = jax_workflow(tiny_layers())
    twf = StandardWorkflow(tiny_layers(), SAMPLE, device="cpu")
    assert [f.name for f in twf.forwards] == [f.name for f in jwf.forwards]
    for jf, tf in zip(jwf.forwards, twf.forwards):
        assert tuple(tf.output_shape_for((1,) + tf.in_shape[1:])) \
            == (1,) + tuple(jf.output.shape[1:]), jf.name
        for key, arr in jf.params().items():
            assert tuple(getattr(tf, key).shape) == tuple(arr.shape), \
                (jf.name, key)


def test_plans_empty_with_knobs_off():
    (jb, jt), (tb, tt) = _plans(tiny_layers())
    assert jb == tb == {} and jt == tt == {}


def test_plans_match_with_fusion_on():
    with knobs(fused_elementwise=True, fused_tail=True):
        (jb, jt), (tb, tt) = _plans(tiny_layers())
    assert sorted(tb) == [0, 3]
    assert tb == jb
    assert tt == jt
    assert sorted(tt) == [6, 7, 8, 10, 12]
    assert tt[10] == ("fc_epilogue", 2, 0.5, 11)


def test_block_plan_alone_matches():
    with knobs(fused_elementwise=True):
        (jb, jt), (tb, tt) = _plans(tiny_layers())
    assert tb == jb and sorted(tb) == [0, 3]
    assert tt == jt == {}


@pytest.mark.parametrize("opt_out", ["lrn_pow", "lrn_autodiff", "pallas_lrn"])
def test_lrn_formulation_knobs_disable_blocks(opt_out):
    """The LRN-formulation knobs keep their runs pure: no block plan, and
    the tail plan then takes conv1/conv2's bias+ReLU too."""
    with knobs(fused_elementwise=True, fused_tail=True, **{opt_out: True}):
        (jb, jt), (tb, tt) = _plans(tiny_layers())
    assert jb == tb == {}
    assert tt == jt
    assert sorted(tt) == [0, 3, 6, 7, 8, 10, 12]


def test_partial_tiling_falls_back():
    """A pool with partial edge windows (4x4/s2 on 15x15 -> 7x7) does not
    match; the first block stays composed, the second still fuses."""
    layers = tiny_layers(pool1={"kx": 4, "ky": 4, "sliding": (2, 2)})
    with knobs(fused_elementwise=True, fused_tail=True):
        (jb, jt), (tb, tt) = _plans(layers)
    assert tb == jb and sorted(tb) == [3]
    assert tt == jt and 0 in tt
