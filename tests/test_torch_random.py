"""The generation sampler's random stream (``znicz_torch/ops/random.py``)
and in-graph sampler (``serving/model._sample_tokens``) against the JAX
package on the CPU:

  - ``bits`` equals ``jax.random.bits(fold_in(PRNGKey(s), t), (v,),
    uint32)`` bit for bit, seeds 0 and above 2**31 among them;
  - ``gumbel`` is within ``GUMBEL_ULPS`` ulp of ``jax.random.gumbel``,
    the ulp taken at ``max(|noise|, 1)``: the two ``log`` implementations
    differ in their last bits, and ``-log(-log(u))`` carries that error
    as an absolute one near 0;
  - ``_sample_tokens`` on identical logits gives the reference's tokens,
    and its log-probabilities to ``LOGP_TOL``, greedy and sampled, with
    and without a top-k cut.
"""

import numpy as np
import pytest
import torch

#: the noise's band, in ulp of max(|noise|, 1)
GUMBEL_ULPS = 4
#: the sampled tokens' log-probabilities
LOGP_TOL = {"rtol": 1e-6, "atol": 1e-6}

SEEDS = (0, 1, 7, 41, 2**31 - 1, 2**31, 2**31 + 5, 3_000_000_000,
         2**32 - 1)


def _jax_noise(seeds, pos, v, kind):
    import jax
    import jax.numpy as jnp

    def one(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        if kind == "bits":
            return jax.random.bits(key, (v,), jnp.uint32)
        return jax.random.gumbel(key, (v,), jnp.float32)

    return np.asarray(jax.vmap(one)(np.asarray(seeds, np.uint32),
                                    np.asarray(pos, np.int32)))


def _grid(n=64):
    rng = np.random.default_rng(5)
    seeds = np.concatenate([np.repeat(SEEDS, 2),
                            rng.integers(0, 2**32, n, dtype=np.int64)])
    pos = np.concatenate([np.tile([0, 63], len(SEEDS)),
                          rng.integers(0, 4096, n)])
    return seeds, pos


@pytest.mark.parametrize("v", [1, 32, 257])
def test_bits_equal_jax_bit_for_bit(v):
    from znicz_torch.ops import random as rnd

    seeds, pos = _grid()
    want = _jax_noise(seeds, pos, v, "bits").astype(np.int64)
    got = rnd.bits(rnd.fold_in(torch.from_numpy(seeds),
                               torch.from_numpy(pos)), v).numpy()
    np.testing.assert_array_equal(got, want)


def test_threefry_counter_words_are_the_references():
    """The raw block function on a few words against the JAX package's
    own ``threefry_2x32``."""
    from jax._src import prng as jprng

    from znicz_torch.ops import random as rnd

    k = np.asarray([0x13198A2E, 0x03707344], np.uint32)
    x = np.asarray([[0, 1, 0xFFFFFFFF], [7, 0x243F6A88, 12345]], np.uint32)
    want = np.asarray(jprng.threefry_2x32(k, x.reshape(-1))).reshape(2, 3)
    y0, y1 = rnd.threefry2x32(int(k[0]), int(k[1]),
                              torch.from_numpy(x[0].astype(np.int64)),
                              torch.from_numpy(x[1].astype(np.int64)))
    got = np.stack([y0.numpy(), y1.numpy()])
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_gumbel_within_ulps_of_jax():
    from znicz_torch.ops import random as rnd

    seeds, pos = _grid(192)
    want = _jax_noise(seeds, pos, 256, "gumbel")
    got = rnd.gumbel(rnd.fold_in(torch.from_numpy(seeds),
                                 torch.from_numpy(pos)), 256).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) / ulp).max() <= GUMBEL_ULPS


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.0, 5), (0.7, 0),
                                        (1.0, 5), (1.3, 1)])
def test_sample_tokens_equal_the_references(temp, top_k):
    """Identical logits (with ties planted) through both samplers: the
    same tokens, the log-probabilities to ``LOGP_TOL``.  Each row keys
    its noise on its own (seed, position)."""
    import jax.numpy as jnp

    from znicz_tpu.serving.model import _sample_tokens as jsample
    from znicz_torch.serving.model import _sample_tokens

    rng = np.random.default_rng(19)
    b, v = 48, 32
    logits = rng.normal(size=(b, v)).astype(np.float32) * 3
    logits[0, 4] = logits[0, 9] = logits[0].max() + 1   # a greedy tie
    temps = np.full(b, temp, np.float32)
    top_ks = np.full(b, top_k, np.int32)
    seeds = rng.integers(0, 2**32, b, dtype=np.int64)
    seeds[:3] = (0, 2**31 + 3, 2**32 - 1)
    t = rng.integers(0, 64, b)
    jt, jl = jsample(jnp.asarray(logits), jnp.asarray(temps),
                     jnp.asarray(top_ks), jnp.asarray(seeds, jnp.uint32),
                     jnp.asarray(t, jnp.int32))
    tt, tl = _sample_tokens(torch.from_numpy(logits),
                            torch.from_numpy(temps),
                            torch.from_numpy(top_ks.astype(np.int64)),
                            torch.from_numpy(seeds), torch.from_numpy(t))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGP_TOL)
    if temp == 0:
        assert int(tt[0]) == 4                  # a tie: the lowest id
    if top_k == 1:                  # row 0's tie keeps both ids in the cut
        np.testing.assert_array_equal(tt.numpy()[1:],
                                      logits[1:].argmax(-1))


def test_sampled_tokens_ignore_their_neighbours():
    """A row's draw is a function of its own (seed, position): the same
    row alone and among other rows samples the same token."""
    from znicz_torch.serving.model import _sample_tokens

    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    temp = torch.full((8,), 0.9)
    top_k = torch.zeros(8, dtype=torch.int64)
    seeds = torch.arange(8, dtype=torch.int64) * 977
    t = torch.arange(8, dtype=torch.int64)
    together, _ = _sample_tokens(logits, temp, top_k, seeds, t)
    for i in range(8):
        alone, _ = _sample_tokens(logits[i:i + 1], temp[i:i + 1],
                                  top_k[i:i + 1], seeds[i:i + 1], t[i:i + 1])
        assert int(alone[0]) == int(together[i])
