"""The layer kinds of the MNIST and CIFAR10 samples against the JAX
reference on the CPU, forward and gradient, and the samples' seeded
starting state.

  - each family of module kinds (fully connected, convolution, average
    pooling, max-abs pooling) in one parametrised test: the same numpy
    input and weights through the reference unit's ``apply`` (under
    ``jax.vjp``) and the port's module (under autograd), forward within
    rtol 1e-5 / atol 1e-6, the gradients of the input and the parameters
    within ``STEP_TOL``;
  - the reference's "RELU" is softplus: the port's ``F.softplus``
    returns x past its threshold of 20, the reference's
    ``jax.nn.softplus`` computes ``logaddexp``; StrictRELU's slope at
    exactly 0 is the reference's one half; each is pinned against the
    reference there, value and slope;
  - ``datasets.digits`` bit-equal to the reference's from the same seed;
  - the MNIST and CIFAR10 workflows' seeded initial parameters bit-equal
    to the reference's, under the reference's unit names (MNIST's
    hand-wired ``fwd0``/``fwd1``).
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_planner import knobs
from test_torch_train import STEP_TOL, _reset_both

FWD_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _vjp_both(jax_unit, mod, x, params, dy_seed):
    """(forward, grads) of the reference unit's ``apply`` and of the port's
    module on the same input ``x`` and parameters ``params`` ({leaf:
    numpy}), pulled back from the same random cotangent.  grads are {"x":
    ..., leaf: ...} as numpy."""
    import jax
    import jax.numpy as jnp

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, vjp = jax.vjp(lambda p, a: jax_unit.apply(p, a), jp,
                        jnp.asarray(x))
    dy = _rand(np.shape(want), dy_seed)
    jgp, jgx = vjp(jnp.asarray(dy))
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    leaves = [getattr(mod, k) for k in params]
    for p in leaves:
        p.requires_grad_(True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    got = mod(tx)
    tg = torch.autograd.grad(got, [tx] + leaves, torch.from_numpy(dy))
    want_g = {"x": np.asarray(jgx), **{k: np.asarray(jgp[k])
                                       for k in params}}
    got_g = {"x": tg[0].numpy(), **{k: g.numpy()
                                    for k, g in zip(params, tg[1:])}}
    return (got.detach().numpy(), np.asarray(want)), (got_g, want_g)


def _assert_match(fwd, grads):
    got, want = fwd
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)
    got_g, want_g = grads
    assert set(got_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k,
                                   **STEP_TOL)


# -- fully connected -----------------------------------------------------------


@pytest.mark.parametrize("cls,x_scale", [
    ("All2All", 1.0), ("All2AllTanh", 1.0), ("All2AllRELU", 1.0),
    ("All2AllRELU", 12.0),                # pre-activations well past |20|
    ("All2AllSigmoid", 1.0)])
def test_all2all_kinds_match_reference(cls, x_scale):
    from znicz_torch import all2all as tmod
    from znicz_tpu import all2all as jmod

    in_shape = (4, 3, 3, 2)                    # NHWC, flattened H,W,C
    mod = getattr(tmod, cls)(name="f", output_sample_shape=9)
    mod.build(in_shape, torch.device("cpu"))
    params = {"weights": _rand(tuple(mod.weights.shape), 21, 0.6),
              "bias": _rand((9,), 22, 0.1)}
    x = _rand(in_shape, 23, x_scale)
    fwd, grads = _vjp_both(getattr(jmod, cls)(None, name="f",
                                              output_sample_shape=9),
                           mod, x, params, 24)
    if x_scale > 1.0:
        pre = x.reshape(4, -1) @ params["weights"].T + params["bias"]
        assert (pre > 20).any() and (pre < -20).any()
    _assert_match(fwd, grads)


@pytest.mark.parametrize("name,x", [
    # F.softplus returns x above 20; jax.nn.softplus is logaddexp(x, 0)
    ("relu_log", [-60.0, -25.0, -20.5, -20.0, -19.5, 19.5, 20.0, 20.001,
                  20.5, 25.0, 60.0]),
    # max(x, 0) at x == 0: jnp.maximum halves the gradient there
    ("strict_relu", [-1.0, -0.0, 0.0, 1e-30, 2.0]),
])
def test_activation_edges_match_the_reference(name, x):
    """Value and slope where the two libraries' formulations part: in
    float32 they agree."""
    import jax
    import jax.numpy as jnp

    from znicz_torch.ops import activations
    from znicz_tpu.ops import activations as jact

    x = np.array(x, np.float32)
    want, vjp = jax.vjp(getattr(jact, name), jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    got = getattr(activations, name)(tx)
    g, = torch.autograd.grad(got, tx, torch.ones_like(tx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(vjp(jnp.ones_like(want))[0]),
                               **FWD_TOL)


# -- convolution ---------------------------------------------------------------


@pytest.mark.parametrize("cls,kw,in_shape", [
    ("Conv", {"n_kernels": 6, "kx": 3, "ky": 3, "sliding": (2, 2)},
     (2, 9, 9, 3)),
    ("ConvTanh", {"n_kernels": 5, "kx": 5, "ky": 5,
                  "padding": (2, 2, 2, 2)}, (2, 8, 8, 3)),
    ("ConvRELU", {"n_kernels": 4, "kx": 3, "ky": 2, "sliding": (2, 1),
                  "padding": (1, 2, 0, 1)}, (2, 7, 8, 4)),
])
def test_conv_kinds_match_reference(cls, kw, in_shape):
    from znicz_torch import conv as tmod
    from znicz_tpu import conv as jmod

    mod = getattr(tmod, cls)(name="c", **kw)
    mod.build(in_shape, torch.device("cpu"))
    params = {"weights": _rand(tuple(mod.weights.shape), 11, 0.3),
              "bias": _rand(tuple(mod.bias.shape), 12, 0.1)}
    fwd, grads = _vjp_both(getattr(jmod, cls)(None, name="c", **kw), mod,
                           _rand(in_shape, 13), params, 14)
    assert fwd[0].shape == mod.output_shape_for(in_shape)
    _assert_match(fwd, grads)


@pytest.mark.parametrize("kind", ["conv", "conv_tanh", "conv_relu",
                                  "conv_strict_relu"])
def test_only_strict_relu_convolutions_take_the_bias_relu_kernel(kind):
    """The bias+ReLU kernel (K2/K2b) computes relu(x + b): the planner
    matches ConvStrictRELU alone, as the reference's does."""
    from znicz_torch.fused_block import plan_fused_tail
    from znicz_torch.standard_workflow import StandardWorkflow
    from znicz_tpu import pallas_fused_block as jfb
    from test_torch_planner import jax_workflow

    layers = [{"type": kind, "->": {"n_kernels": 4, "kx": 3, "ky": 3}},
              {"type": "softmax", "->": {"output_sample_shape": 3}}]
    twf = StandardWorkflow(layers, (7, 7, 2), device="cpu")
    jwf = jax_workflow(layers, sample_shape=(7, 7, 2))
    with knobs(fused_tail=True):
        got = {i: s.kind for i, s in plan_fused_tail(twf.forwards).items()}
        want = {i: s.kind
                for i, s in jfb.plan_fused_tail(jwf.forwards).items()}
    assert got == want
    assert got == ({0: "conv_bias_relu"} if kind == "conv_strict_relu"
                   else {})


# -- pooling -------------------------------------------------------------------


def _pool_case(cls, kw, x):
    from znicz_torch import pooling as tmod
    from znicz_tpu import pooling as jmod
    from znicz_tpu.memory import Array

    mod = getattr(tmod, cls)(name="p", **kw)
    mod.build(x.shape, torch.device("cpu"))
    ref = getattr(jmod, cls)(None, name="p", **kw)
    ref.input = Array(np.zeros(x.shape, np.float32))
    fwd, grads = _vjp_both(ref, mod, x, {}, 41)
    assert fwd[0].shape == mod.output_shape_for(x.shape)
    return mod, ref, fwd, grads


@pytest.mark.parametrize("kw,in_shape,exact", [
    ({"kx": 2, "ky": 2}, (2, 8, 8, 3), True),          # CIFAR's pools
    ({"kx": 2, "ky": 2}, (2, 7, 7, 3), False),         # partial windows
    ({"kx": 3, "ky": 3, "sliding": (2, 2)}, (1, 6, 9, 2), False),
    ({"kx": 3, "ky": 3}, (1, 2, 2, 4), False),         # h < ky
])
def test_avg_pooling_matches_reference(kw, in_shape, exact):
    """Each window's sum over its count of real elements: a partial
    window is not diluted by its zero padding."""
    mod, ref, fwd, grads = _pool_case("AvgPooling", kw,
                                      _rand(in_shape, 31))
    assert mod.exact_tiling() == ref.exact_tiling() == exact
    np.testing.assert_array_equal(mod.window_counts(), ref.window_counts())
    if not exact:
        assert mod.window_counts().min() < kw["kx"] * kw["ky"]
    _assert_match(fwd, grads)


def _tie_heavy(shape, seed):
    """StrictRELU output rounded to halves: most windows hold several
    zeros or equal values, some are all zeros, and some tie +v with -v."""
    x = np.maximum(_rand(shape, seed), 0.0)
    x = np.round(x * 2.0) / 2.0
    x[0, :2, :2, 0] = [[0.5, -0.5], [0.25, 0.0]]      # |max| == |min|
    return x.astype(np.float32)


@pytest.mark.parametrize("kw,data", [
    ({"kx": 2, "ky": 2}, "ties"),
    ({"kx": 3, "ky": 3, "sliding": (2, 2)}, "ties"),
    ({"kx": 2, "ky": 2}, "random"),
    ({"kx": 3, "ky": 2}, "random"),                    # partial windows
])
def test_maxabs_pooling_matches_reference(kw, data):
    """The signed value of larger magnitude, the maximum on an exact tie;
    the gradient goes to the same element as the reference's, also where
    a window's elements tie (torch's and XLA's max-pool backward each take
    the first in window order)."""
    shape = (2, 7, 8, 3)
    x = _tie_heavy(shape, 51) if data == "ties" else _rand(shape, 52)
    _, _, fwd, grads = _pool_case("MaxAbsPooling", kw, x)
    np.testing.assert_array_equal(*fwd)
    if data == "ties" and kw["kx"] == 2:
        assert fwd[0][0, 0, 0, 0] == 0.5
        nz = grads[1]["x"] != 0
        assert nz.sum() < x.size / 3           # one element a window
    np.testing.assert_array_equal(*[g["x"] for g in grads])


# -- data and seeded starts ----------------------------------------------------


def test_digits_bit_equal():
    from znicz_torch import datasets as tdata
    from znicz_tpu import datasets as jdata

    _reset_both()
    jd, jl = jdata.digits(40)
    td, tl = tdata.digits(40)
    assert td.shape == (40, 28, 28) and td.dtype == np.float32
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)
    assert len(set(tl.tolist())) == 10


@contextlib.contextmanager
def sample_config(sample, **values):
    """Set ``root.<sample>.<dotted key>`` in both packages' config trees
    (after the sample modules have set their defaults), and restore the
    old values on exit."""
    import importlib

    from znicz_torch.core.config import root as troot
    from znicz_tpu.core.config import root as jroot

    for pkg in ("znicz_torch", "znicz_tpu"):
        importlib.import_module(f"{pkg}.samples.{sample}")
    saved = []
    try:
        for key, val in values.items():
            path = f"{sample}.{key.replace('__', '.')}"
            for tree in (troot, jroot):
                saved.append((tree, path, tree.get_by_path(path)))
                tree.set_by_path(path, val)
        yield
    finally:
        for tree, path, old in reversed(saved):
            tree.set_by_path(path, old)


#: sample -> its workflow class, the same name in both packages
WORKFLOWS = {"mnist": "MnistWorkflow", "cifar": "CifarWorkflow"}


def jax_sample(sample, tmp_path):
    """The reference sample's workflow, initialised on the CPU after
    ``prng.reset(1013)``."""
    import importlib

    from znicz_tpu.core import prng
    from znicz_tpu.core.config import root as jroot

    jroot.common.dirs.snapshots = str(tmp_path)
    mod = importlib.import_module(f"znicz_tpu.samples.{sample}")
    prng.reset(1013)
    wf = getattr(mod, WORKFLOWS[sample])()
    wf.initialize(device=None)
    return wf


def port_sample(sample, tmp_path):
    """The port's sample workflow on the CPU after ``prng.reset(1013)``,
    its snapshots going to ``tmp_path``."""
    import importlib

    from znicz_torch.core import prng
    from znicz_torch.core.config import root as troot

    troot.common.dirs.snapshots = str(tmp_path)
    mod = importlib.import_module(f"znicz_torch.samples.{sample}")
    prng.reset(1013)
    return getattr(mod, WORKFLOWS[sample])(device="cpu")


def jax_params(jwf):
    return {f.name: {k: np.array(a.map_read()) for k, a in f.params().items()}
            for f in jwf.forwards if f.has_weights}


SMALL = {"mnist": {"loader__n_train": 30, "loader__n_valid": 10,
                   "loader__minibatch_size": 10},
         "cifar": {"loader__n_train": 20, "loader__n_valid": 10,
                   "loader__minibatch_size": 10}}


@pytest.mark.parametrize("sample,names", [
    ("mnist", ["fwd0", "fwd1"]),
    ("cifar", ["fwd_conv_strict_relu_0", "fwd_conv_strict_relu_3",
               "fwd_conv_strict_relu_5", "fwd_all2all_tanh_7",
               "fwd_softmax_8"])])
def test_sample_starts_bit_equal(sample, names, tmp_path):
    """Data, labels, class order and every initial parameter of the seeded
    sample workflow, under the reference's unit names."""
    from znicz_torch.weights import params_to_numpy

    with sample_config(sample, **SMALL[sample]):
        jwf = jax_sample(sample, tmp_path)
        twf = port_sample(sample, tmp_path)
    np.testing.assert_array_equal(twf.loader.original_data,
                                  np.asarray(jwf.loader.original_data.mem))
    np.testing.assert_array_equal(twf.loader.original_labels,
                                  np.asarray(jwf.loader.original_labels.mem))
    assert twf.loader.class_lengths == list(jwf.loader.class_lengths) \
        == [0, 10, SMALL[sample]["loader__n_train"]]
    assert twf.sample_shape == {"mnist": (784,),
                                "cifar": (32, 32, 3)}[sample]
    want = jax_params(jwf)
    got = params_to_numpy(twf)
    assert sorted(got) == sorted(want) == sorted(names)
    for name, leaves in want.items():
        assert set(got[name]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[name][k], v,
                                          err_msg=f"{name}.{k}")
    assert [f.name for f in twf.forwards] == [f.name for f in jwf.forwards]
