"""The port's kernel stages and modules against the JAX reference on the
CPU.  Inputs are made with numpy from a seed and fed to both packages.

The kernel stages compare the port's wrappers — which take their plain
PyTorch versions for CPU tensors — with the reference's Pallas kernels,
run in interpret mode as the reference's own tests run them here.  Both
sides do the same float32 operations in the same order (the window sum's
shift order, the rsqrt form of s^-0.75, pow in the standalone LRN), so
the tolerance covers only the libraries' rsqrt/sqrt/pow, which may
differ by an ulp or two: rtol 1e-5, atol 1e-6.

The modules compare with the reference units' ``apply``.  The
convolutions and matrix products sum in another order in the two
libraries: rtol 1e-4, atol 1e-5 at these widths."""

import numpy as np
import pytest
import torch

from test_torch_planner import knobs

KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-6}
MODULE_TOL = {"rtol": 1e-4, "atol": 1e-5}
N, ALPHA, BETA, K = 5, 1e-4, 0.75, 2.0


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _both(a):
    import jax.numpy as jnp

    return jnp.asarray(a), torch.from_numpy(a.copy())


# -- the three kernel stages ---------------------------------------------------


@pytest.mark.parametrize("shape,pool,beta", [
    ((2, 9, 9, 32), (3, 3, 2, 2), 0.75),     # even C, AlexNet's pool
    ((2, 9, 9, 13), (3, 3, 2, 2), 0.75),     # odd C
    ((1, 8, 8, 96), (2, 2, 2, 2), 0.75),     # conv1's width, 2x2 pool
    ((2, 7, 7, 12), (3, 3, 2, 2), 0.5),      # pow, not the rsqrt form
])
def test_fused_block_matches_reference_kernel(shape, pool, beta):
    from znicz_torch.fused_block import fused_block
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    jx, tx = _both(_rand(shape, 3, 2.0))
    jb, tb = _both(_rand(shape[-1:], 4, 0.1))
    before = fused_block.launches
    got = fused_block(tx, tb, N, ALPHA, beta, K, pool)
    want = jax_fused_block(jx, jb, N, ALPHA, beta, K, pool)
    assert fused_block.launches == before      # CPU: no kernel launch
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_fused_block_refuses_non_tiling_pool():
    from znicz_torch.fused_block import fused_block

    x = torch.from_numpy(_rand((1, 6, 6, 8), 31))
    with pytest.raises(ValueError, match="tile"):
        fused_block(x, torch.zeros(8), N, ALPHA, BETA, K, (3, 3, 2, 2))


@pytest.mark.parametrize("shape", [(2, 5, 5, 384), (2, 3, 3, 13)])
def test_bias_relu_matches_reference_kernel(shape):
    from znicz_torch.fused_block import fused_bias_relu
    from znicz_tpu.pallas_fused_block import fused_bias_relu as jax_br

    jx, tx = _both(_rand(shape, 5))
    jb, tb = _both(_rand(shape[-1:], 6, 0.3))
    got = fused_bias_relu(tx, tb)
    # one add and one max: bit-identical
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_br(jx, jb)))


@pytest.mark.parametrize("shape,n,beta", [
    ((2, 5, 5, 32), 5, 0.75),               # even C
    ((3, 4, 4, 13), 5, 0.75),               # odd C, rows not a tile multiple
    ((2, 3, 3, 16), 3, 0.6),
])
def test_lrn_matches_reference_kernel(shape, n, beta):
    from znicz_torch.ops.lrn import lrn
    from znicz_tpu.ops.lrn_pallas import lrn as jax_lrn

    jx, tx = _both(np.abs(_rand(shape, 7, 3.0)))
    got = lrn(tx, n, ALPHA, beta, K)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_lrn(jx, n, ALPHA, beta, K)),
                               **KERNEL_TOL)


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on neither the CPU nor a CUDA device is refused: nothing
    falls back to the plain version except a CPU tensor."""
    from znicz_torch.fused_block import fused_bias_relu, fused_block
    from znicz_torch.ops.lrn import lrn

    x = torch.empty((1, 9, 9, 4), device="meta")
    b = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block(x, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bias_relu(x, b)
    with pytest.raises(ValueError, match="unsupported device"):
        lrn(x)


# -- modules against the reference units' apply --------------------------------


def _load(mod, w, b):
    with torch.no_grad():
        mod.weights.copy_(torch.from_numpy(w))
        if b is not None:
            mod.bias.copy_(torch.from_numpy(b))


@pytest.mark.parametrize("kw,in_shape", [
    ({"n_kernels": 6, "kx": 3, "ky": 3, "sliding": (2, 2)}, (2, 9, 9, 3)),
    ({"n_kernels": 5, "kx": 3, "ky": 2, "sliding": (2, 1),
      "padding": (1, 2, 0, 1)}, (2, 7, 8, 4)),          # asymmetric pad
    ({"n_kernels": 4, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2)},
     (1, 6, 6, 5)),
])
def test_conv_matches_reference(kw, in_shape):
    import jax.numpy as jnp

    from znicz_torch.conv import ConvStrictRELU
    from znicz_tpu.conv import ConvStrictRELU as JConv

    mod = ConvStrictRELU(name="c", **kw)
    mod.build(in_shape, torch.Generator(), torch.device("cpu"))
    w = _rand(tuple(mod.weights.shape), 11, 0.3)
    b = _rand(tuple(mod.bias.shape), 12, 0.1)
    _load(mod, w, b)
    jx, tx = _both(_rand(in_shape, 13))
    want = JConv(None, name="c", **kw).apply(
        {"weights": jnp.asarray(w), "bias": jnp.asarray(b)}, jx)
    got = mod(tx)
    assert tuple(got.shape) == tuple(want.shape) \
        == mod.output_shape_for(in_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("cls,transposed", [
    ("All2AllStrictRELU", False), ("All2AllStrictRELU", True),
    ("All2AllSoftmax", False)])
def test_all2all_matches_reference(cls, transposed):
    import jax.numpy as jnp

    from znicz_torch import all2all as tmod
    from znicz_tpu import all2all as jmod

    in_shape = (3, 3, 3, 4)                    # NHWC, flattened H,W,C
    mod = getattr(tmod, cls)(name="f", output_sample_shape=7,
                             weights_transposed=transposed)
    mod.build(in_shape, torch.Generator(), torch.device("cpu"))
    w = _rand(tuple(mod.weights.shape), 21, 0.2)
    b = _rand((7,), 22, 0.1)
    _load(mod, w, b)
    jx, tx = _both(_rand(in_shape, 23))
    want = getattr(jmod, cls)(None, name="f", output_sample_shape=7,
                              weights_transposed=transposed).apply(
        {"weights": jnp.asarray(w), "bias": jnp.asarray(b)}, jx)
    np.testing.assert_allclose(mod(tx).numpy(), np.asarray(want),
                               **MODULE_TOL)


@pytest.mark.parametrize("kw,in_shape,exact", [
    ({"kx": 3, "ky": 3, "sliding": (2, 2)}, (2, 9, 9, 4), True),
    ({"kx": 2, "ky": 2}, (2, 7, 7, 3), False),          # partial edge
    ({"kx": 3, "ky": 3, "sliding": (2, 2)}, (1, 4, 6, 2), False),
    ({"kx": 3, "ky": 3, "sliding": (2, 2)}, (1, 2, 2, 5), False),  # h < ky
])
def test_max_pooling_matches_reference(kw, in_shape, exact):
    from znicz_torch.pooling import MaxPooling
    from znicz_tpu.memory import Array
    from znicz_tpu.pooling import MaxPooling as JPool

    mod = MaxPooling(name="p", **kw)
    out_shape = mod.build(in_shape, torch.Generator(), torch.device("cpu"))
    ref = JPool(None, name="p", **kw)
    ref.input = Array(np.zeros(in_shape, np.float32))
    assert mod.exact_tiling() == ref.exact_tiling() == exact
    jx, tx = _both(_rand(in_shape, 31))
    want = np.asarray(ref.apply({}, jx))
    got = mod(tx).numpy()
    assert got.shape == want.shape == out_shape
    np.testing.assert_array_equal(got, want)             # max is exact


@pytest.mark.parametrize("n,knob", [
    (5, None), (5, "pallas_lrn"), (5, "lrn_pow"), (5, "lrn_autodiff"),
    (4, None)])
def test_lrn_module_matches_reference(n, knob):
    from znicz_torch.lrn import LRNormalizerForward
    from znicz_tpu.lrn import LRNormalizerForward as JLRN

    jx, tx = _both(np.abs(_rand((2, 4, 4, 11), 41, 3.0)))
    with knobs(**({knob: True} if knob else {})):
        want = JLRN(None, name="n", n=n).apply({}, jx)
        got = LRNormalizerForward(name="n", n=n)(tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
