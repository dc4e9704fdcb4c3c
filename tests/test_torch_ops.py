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
    from znicz_torch.fused_block import fused_block, fused_block_fwd
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    jx, tx = _both(_rand(shape, 3, 2.0))
    jb, tb = _both(_rand(shape[-1:], 4, 0.1))
    before = fused_block_fwd.launches
    got = fused_block(tx, tb, N, ALPHA, beta, K, pool)
    want = jax_fused_block(jx, jb, N, ALPHA, beta, K, pool)
    assert fused_block_fwd.launches == before  # CPU: no kernel launch
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
    mod.build(in_shape, torch.device("cpu"))
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
    mod.build(in_shape, torch.device("cpu"))
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
    out_shape = mod.build(in_shape, torch.device("cpu"))
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


# -- the backward stages against jax.vjp of the reference -----------------------
#
# dx: the same float32 operations in the same order on both sides, so
# rtol 1e-5 / atol 1e-6 as the forwards.  db: a sum over batch and plane,
# which the libraries reduce in different orders: rtol 1e-4 / atol 1e-5.

DB_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _tied(shape, seed):
    """Forced ties: image 0 is spatially constant (every window a full tie,
    negative channels all-zero windows after ReLU), the rest take values
    in {-1, -0.5, 0, 0.5, 1} (zero windows and equal maxima)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-2, 3, size=shape) * 0.5).astype(np.float32)
    x[0] = rng.normal(size=shape[-1]).astype(np.float32)
    return x


@pytest.mark.parametrize("shape,pool,beta,tied", [
    ((2, 9, 9, 32), (3, 3, 2, 2), 0.75, False),
    ((2, 9, 9, 13), (3, 3, 2, 2), 0.75, False),
    ((1, 8, 8, 96), (2, 2, 2, 2), 0.75, False),
    ((2, 7, 7, 12), (3, 3, 2, 2), 0.5, False),
    ((3, 9, 9, 8), (3, 3, 2, 2), 0.75, True),
], ids=["c32", "c13", "c96_pool2", "beta0.5", "ties"])
def test_fused_block_backward_matches_reference_vjp(shape, pool, beta, tied):
    import jax

    from znicz_torch.fused_block import (fused_block, fused_block_bwd,
                                         fused_block_bwd_plain,
                                         fused_block_plain)
    from znicz_tpu.pallas_fused_block import fused_block as jax_fused_block

    x = _tied(shape, 51) if tied else _rand(shape, 51, 2.0)
    b = np.zeros(shape[-1], np.float32) if tied \
        else _rand(shape[-1:], 52, 0.1)
    jx, tx = _both(x)
    jb, tb = _both(b)
    want, vjp = jax.vjp(
        lambda xx, bb: jax_fused_block(xx, bb, N, ALPHA, beta, K, pool),
        jx, jb)
    jdp, tdp = _both(_rand(tuple(want.shape), 53))
    gx, gb = vjp(jdp)
    tx.requires_grad_(True)
    tb.requires_grad_(True)
    before = fused_block_bwd.launches
    got = fused_block(tx, tb, N, ALPHA, beta, K, pool)
    dx, db = torch.autograd.grad(got, (tx, tb), tdp)
    assert fused_block_bwd.launches == before   # CPU: the plain version
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **KERNEL_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), **DB_TOL)
    if tied:
        # the equal split is the plain version's own, not autograd's
        auto, = torch.autograd.grad(
            fused_block_plain(tx, tb, N, ALPHA, beta, K, pool), tx, tdp)
        assert not np.allclose(auto.numpy(), np.asarray(gx), **KERNEL_TOL)
    pdx, _ = fused_block_bwd_plain(tx.detach(), tb.detach(), tdp, N, ALPHA,
                                   beta, K, pool)
    np.testing.assert_array_equal(pdx.numpy(), dx.numpy())


@pytest.mark.parametrize("shape", [(2, 5, 5, 384), (2, 3, 3, 13)])
def test_bias_relu_backward_matches_reference_vjp(shape):
    import jax

    from znicz_torch.fused_block import fused_bias_relu
    from znicz_tpu.pallas_fused_block import fused_bias_relu as jax_br

    x = _rand(shape, 61)
    x[0, 0, 0, :4] = 0.0                      # a + b == -b exactly: gate
    b = _rand(shape[-1:], 62, 0.3)
    b[:4] = 0.0                               # a == 0 exactly: gate shut
    jx, tx = _both(x)
    jb, tb = _both(b)
    _, vjp = jax.vjp(jax_br, jx, jb)
    jdp, tdp = _both(_rand(shape, 63))
    gx, gb = vjp(jdp)
    tx.requires_grad_(True)
    tb.requires_grad_(True)
    dx, db = torch.autograd.grad(fused_bias_relu(tx, tb), (tx, tb), tdp)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(gx))
    assert not dx[0, 0, 0, :4].any()          # the strict gate a > 0
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), **DB_TOL)


@pytest.mark.parametrize("shape,n,beta", [
    ((2, 5, 5, 32), 5, 0.75),
    ((3, 4, 4, 13), 5, 0.75),
    ((2, 3, 3, 16), 3, 0.6),
])
def test_lrn_backward_matches_reference_vjp(shape, n, beta):
    import jax

    from znicz_torch.ops.lrn import lrn, lrn_bwd
    from znicz_tpu.ops.lrn_pallas import lrn as jax_lrn

    jx, tx = _both(np.abs(_rand(shape, 71, 3.0)))
    _, vjp = jax.vjp(lambda xx: jax_lrn(xx, n, ALPHA, beta, K), jx)
    jdy, tdy = _both(_rand(shape, 72))
    gx, = vjp(jdy)
    tx.requires_grad_(True)
    before = lrn_bwd.launches
    dx, = torch.autograd.grad(lrn(tx, n, ALPHA, beta, K), tx, tdy)
    assert lrn_bwd.launches == before
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **KERNEL_TOL)


@pytest.mark.parametrize("beta,knob", [(0.75, None), (0.75, "lrn_pow"),
                                       (0.6, None)])
def test_lrn_ref_backward_matches_reference_vjp(beta, knob):
    import jax

    from znicz_torch.lrn import lrn_ref
    from znicz_tpu.lrn import lrn_ref as jax_lrn_ref

    shape = (2, 4, 4, 11)
    jx, tx = _both(np.abs(_rand(shape, 81, 3.0)))
    jdy, tdy = _both(_rand(shape, 82))
    tx.requires_grad_(True)
    with knobs(**({knob: True} if knob else {})):
        _, vjp = jax.vjp(lambda xx: jax_lrn_ref(xx, N, ALPHA, beta, K), jx)
        gx, = vjp(jdy)
        dx, = torch.autograd.grad(lrn_ref(tx, N, ALPHA, beta, K), tx, tdy)
    # the reference sums its window with reduce_window, the port in the
    # shift order: the same terms, another order
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **KERNEL_TOL)


def test_fc_epilogue_with_injected_mask_matches_reference():
    import jax

    from znicz_torch.fused_block import fused_fc_epilogue
    from znicz_tpu.dropout import DropoutForward as JDropout
    from znicz_tpu.pallas_fused_block import fused_fc_epilogue as jax_epi

    y = _rand((6, 24), 91)
    b = _rand((24,), 92, 0.2)
    key = jax.random.PRNGKey(7)
    mask = np.asarray(JDropout.make_mask(key, y.shape, 0.5))
    calls = []

    def mask_of():
        calls.append(1)
        return torch.from_numpy(mask.copy())

    jy, ty = _both(y)
    jb, tb = _both(b)
    want, vjp = jax.vjp(lambda yy, bb: jax_epi(yy, bb, key, 0.5, True),
                        jy, jb)
    jg, tg = _both(_rand((6, 24), 93))
    gy, gb = vjp(jg)
    ty.requires_grad_(True)
    tb.requires_grad_(True)
    got = fused_fc_epilogue(ty, tb, mask_of)
    dy, db = torch.autograd.grad(got, (ty, tb), tg)
    assert len(calls) == 2                    # the backward regenerates it
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KERNEL_TOL)
    np.testing.assert_allclose(dy.numpy(), np.asarray(gy), **KERNEL_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), **DB_TOL)


def test_softmax_xent_with_padded_rows_matches_reference():
    import jax
    import jax.numpy as jnp

    from znicz_torch.fused_block import fused_softmax_xent
    from znicz_tpu.pallas_fused_block import fused_softmax_xent as jax_xent

    logits = _rand((7, 10), 95, 2.0)
    labels = np.random.default_rng(96).integers(0, 10, 7).astype(np.int32)
    bs = 5                                    # rows 5 and 6 are padding
    jl, tl = _both(logits)
    valid = np.arange(7) < bs
    want, vjp = jax.vjp(lambda lg: jax_xent(lg, jnp.asarray(labels),
                                            jnp.asarray(valid), bs), jl)
    gl, = vjp(jnp.float32(1.0))
    tl.requires_grad_(True)
    got = fused_softmax_xent(tl, torch.from_numpy(labels.astype(np.int64)),
                             torch.from_numpy(valid), bs)
    dl, = torch.autograd.grad(got, tl)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(dl.numpy(), np.asarray(gl), **KERNEL_TOL)
    assert not dl[bs:].any()


def test_backward_wrappers_take_the_plain_version_only_on_the_cpu():
    from znicz_torch.fused_block import bias_relu_bwd, fused_block_bwd
    from znicz_torch.ops.lrn import lrn_bwd

    x = torch.empty((1, 9, 9, 4), device="meta")
    b = torch.empty((4,), device="meta")
    dp = torch.empty((1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block_bwd(x, b, dp)
    with pytest.raises(ValueError, match="unsupported device"):
        bias_relu_bwd(x, b, torch.empty_like(x))
    with pytest.raises(ValueError, match="unsupported device"):
        lrn_bwd(x, torch.empty_like(x))
