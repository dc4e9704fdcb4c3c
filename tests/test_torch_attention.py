"""The sequence ops and modules (``znicz_torch/ops/attention.py``,
``znicz_torch/attention.py``) against the JAX package's on the CPU.

  - ``attention``: causal and not, scalar and per-row offsets, ``k_valid``,
    an all-masked row (zeros, no NaN), to ``OP_TOL`` (1e-6) of the
    reference's; the decode and paged ops to the same band (the pure
    scatters and gathers bit for bit);
  - the modules (MultiHeadAttention, CharEmbedding, the four SeqAll2All
    kinds): the seeded initial parameters bit-equal to the reference
    units', then, after ``weights.params_from_jax``, one forward unit and
    one GD unit run of each package, output, ``err_input`` and the
    updated parameters to ``UNIT_TOL`` (rtol 1e-5 / atol 1e-5);
  - the serving forms (``apply_prefill``, ``apply_prefill_chunk``,
    ``apply_decode``, ``apply_offset``) against the reference's methods;
  - the reference's own cases of ``tests/test_attention.py`` that need
    no ring attention, and ``tests/test_generate.py``'s op cases.
"""

import numpy as np
import pytest
import torch

#: an op of the port against the reference's
OP_TOL = {"rtol": 1e-6, "atol": 1e-6}
#: a module's forward and backward against the reference unit's
UNIT_TOL = {"rtol": 1e-5, "atol": 1e-5}
CPU = torch.device("cpu")


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


def _qkv(seed, b=2, tq=8, tk=8, h=2, d=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32))


def np_attention(q, k, v, causal=False):
    b, t, h, d = q.shape
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        mask = np.triu(np.ones((t, t), bool), 1)
        s = np.where(mask[None, None], -np.inf, s)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


# -- the ops against the reference's ------------------------------------------

OP_CASES = {
    "plain": {},
    "causal": {"causal": True},
    "causal_scalar_offsets": {"causal": True, "q_offset": 4, "k_offset": 2,
                              "tq": 4, "tk": 4},
    "causal_row_offsets": {"causal": True, "q_offset": "rows", "tq": 3},
    "k_valid": {"k_valid": "prefix"},
    "causal_k_valid": {"causal": True, "k_valid": "prefix"},
    "all_masked_row": {"k_valid": "none", "tq": 1},
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_attention_matches_the_reference(case):
    from znicz_torch.ops.attention import attention
    from znicz_tpu.ops.attention import attention as jattention

    kw = dict(OP_CASES[case])
    q, k, v = _qkv(51, tq=kw.pop("tq", 8), tk=kw.pop("tk", 8))
    if kw.get("q_offset") == "rows":
        kw["q_offset"] = np.array([0, 5], np.int32)
    if "k_valid" in kw:
        valid = np.zeros((2, k.shape[1]), bool)
        if kw["k_valid"] == "prefix":
            valid[0, :5] = True
            valid[1, :2] = True
        kw["k_valid"] = valid
    want = np.asarray(jattention(q, k, v, **kw))
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    got = _np(attention(*map(torch.from_numpy, (q, k, v)), **tkw))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **OP_TOL)
    if case == "all_masked_row":
        np.testing.assert_array_equal(got, np.zeros_like(got))


def test_decode_and_paged_ops_match_the_reference():
    import jax.numpy as jnp

    from znicz_torch.ops import attention as tops
    from znicz_tpu.ops import attention as jops

    rng = np.random.default_rng(53)
    b, c, h, d, ps, npages = 2, 8, 2, 4, 4, 6
    cache = rng.normal(size=(b, c, h, d)).astype(np.float32)
    row = rng.normal(size=(b, h, d)).astype(np.float32)
    t = np.array([3, 6], np.int32)
    got = _np(tops.cache_append(torch.from_numpy(cache),
                                torch.from_numpy(row), torch.from_numpy(t)))
    np.testing.assert_array_equal(got, np.asarray(jops.cache_append(
        jnp.asarray(cache), row, t)))
    q1 = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    vc = rng.normal(size=(b, c, h, d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tops.decode_attention(*map(torch.from_numpy, (q1, cache, vc, t)))),
        np.asarray(jops.decode_attention(q1, cache, vc, t)), **OP_TOL)
    pool_k = rng.normal(size=(npages + 1, ps, h, d)).astype(np.float32)
    pool_v = rng.normal(size=(npages + 1, ps, h, d)).astype(np.float32)
    table = np.array([[3, 1], [4, npages]], np.int32)
    np.testing.assert_array_equal(
        _np(tops.paged_gather(torch.from_numpy(pool_k),
                              torch.from_numpy(table))),
        np.asarray(jops.paged_gather(pool_k, table)))
    np.testing.assert_array_equal(
        _np(tops.paged_append(*map(torch.from_numpy,
                                   (pool_k, table, row, t)))),
        np.asarray(jops.paged_append(jnp.asarray(pool_k), table, row, t)))
    np.testing.assert_allclose(
        _np(tops.paged_decode_attention(*map(torch.from_numpy, (
            q1, pool_k, pool_v, table, t)))),
        np.asarray(jops.paged_decode_attention(q1, pool_k, pool_v, table,
                                               t)), **OP_TOL)


# -- the modules against the reference units -----------------------------------

#: id -> (class name, keywords, input shape, ids input, GD class name,
#: need_err_input)
UNIT_CASES = {
    "mha_causal_residual": ("MultiHeadAttention",
                            {"heads": 2, "causal": True, "residual": True},
                            (2, 6, 8), False, "GDMultiHeadAttention", True),
    "mha_plain_head_dim": ("MultiHeadAttention",
                           {"heads": 3, "head_dim": 2}, (2, 5, 8), False,
                           "GDMultiHeadAttention", True),
    "char_embedding": ("CharEmbedding",
                       {"vocab": 11, "embed": 6, "max_len": 9}, (3, 7), True,
                       "GDCharEmbedding", False),
    "seq_all2all": ("SeqAll2All", {"output_sample_shape": 5}, (2, 4, 6),
                    False, "GDSeqAll2All", True),
    "seq_all2all_tanh": ("SeqAll2AllTanh", {"output_sample_shape": 5},
                         (2, 4, 6), False, "GDSeqAll2All", True),
    "seq_all2all_strict_relu": ("SeqAll2AllStrictRELU",
                                {"output_sample_shape": (5,)}, (2, 4, 6),
                                False, "GDSeqAll2All", True),
    "seq_all2all_transposed": ("SeqAll2AllStrictRELU",
                               {"output_sample_shape": 5,
                                "weights_transposed": True}, (2, 4, 6),
                               False, "GDSeqAll2All", True),
    "seq_softmax": ("SeqAll2AllSoftmax", {"output_sample_shape": 7},
                    (2, 4, 6), False, "GDSeqSoftmax", True),
}

GD_KW = {"learning_rate": 0.1, "gradient_moment": 0.9,
         "weights_decay": 0.01}


def _input(shape, ids, seed, vocab=11):
    rng = np.random.default_rng(seed)
    if ids:
        # out-of-range ids too: the lookup clips them
        return rng.integers(0, vocab + 3, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _reference_unit(cls_name, kw, x):
    from znicz_tpu import attention as jatt
    from znicz_tpu.core import prng
    from znicz_tpu.memory import Array as JArray

    prng.reset(1013)
    unit = getattr(jatt, cls_name)(None, name="u", **kw)
    unit.input = JArray(x)
    unit.initialize(device=None)
    return unit


def _port_unit(cls_name, kw, x):
    """The port's module in a one-unit workflow (what ``params_from_jax``
    loads into), built after ``prng.reset(1013)``."""
    from znicz_torch import attention as tatt
    from znicz_torch.core import prng
    from znicz_torch.core.workflow import Workflow
    from znicz_torch.memory import Array
    from znicz_torch.nn_units import ForwardBase

    prng.reset(1013)
    mod = getattr(tatt, cls_name)(name="u", **kw)
    mod.build(x.shape, CPU)
    wf = Workflow(name="w")
    unit = ForwardBase(wf, module=mod)
    unit.input = Array(x)
    unit.initialize(device=CPU)
    return wf, unit


def _ref_params(unit):
    return {k: np.array(a.map_read()) for k, a in unit.params().items()}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_module_forward_and_backward_match_the_reference(case):
    from znicz_torch import attention as tatt
    from znicz_torch.memory import Array
    from znicz_torch.weights import params_from_jax, params_to_numpy
    from znicz_tpu import attention as jatt
    from znicz_tpu.memory import Array as JArray

    cls_name, kw, shape, ids, gd_name, need_err = UNIT_CASES[case]
    x = _input(shape, ids, 61)
    ref = _reference_unit(cls_name, kw, x)
    wf, unit = _port_unit(cls_name, kw, x)
    start = _ref_params(ref)
    # the seeded init is the reference's, bit for bit
    got0 = params_to_numpy(wf)["u"]
    assert sorted(got0) == sorted(start)
    for k in start:
        np.testing.assert_array_equal(got0[k], start[k], err_msg=k)
    # perturbed parameters carried across
    rng = np.random.default_rng(62)
    tree = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in start.items()}
    for k, v in tree.items():
        ref.params()[k].mem = v.copy()
    params_from_jax({"u": tree}, wf)
    ref.run()
    unit.run()
    want = np.array(ref.output.map_read())
    np.testing.assert_allclose(_np(unit.output.devmem), want, **UNIT_TOL)
    err = rng.normal(size=want.shape).astype(np.float32)
    jgd = getattr(jatt, gd_name)(None, name="g", forward=ref,
                                 need_err_input=need_err, **GD_KW)
    jgd.err_output = JArray(err)
    jgd.initialize(device=None)
    jgd.run()
    tgd = getattr(tatt, gd_name)(None, name="g", forward=unit,
                                 need_err_input=need_err, **GD_KW)
    tgd.err_output = Array(err)
    tgd.initialize(device=CPU)
    tgd.run()
    if need_err:
        np.testing.assert_allclose(_np(tgd.err_input.devmem),
                                   np.array(jgd.err_input.map_read()),
                                   **UNIT_TOL)
    after = params_to_numpy(wf)["u"]
    for k, v in _ref_params(ref).items():
        assert not np.array_equal(v, tree[k]), k       # it moved
        np.testing.assert_allclose(after[k], v, err_msg=k, **UNIT_TOL)


def test_char_embedding_refuses_a_long_sequence_and_clips_ids():
    from znicz_torch.attention import CharEmbedding

    with pytest.raises(ValueError, match="exceeds max_len=4"):
        CharEmbedding(name="e", vocab=5, embed=2,
                      max_len=4).build((1, 5), CPU)
    mod = CharEmbedding(name="e", vocab=5, embed=2, max_len=4)
    mod.build((1, 4), CPU)
    x = torch.tensor([[-0.5, 2.9, 4.0, 250.0]])
    np.testing.assert_array_equal(_np(mod.ids(x)), [[0, 2, 4, 4]])
    ids8 = torch.tensor([[0, 2, 4, 250]], dtype=torch.uint8)
    np.testing.assert_array_equal(_np(mod(ids8)), _np(mod(x)))


def test_mha_refuses_the_sequence_parallel_core():
    """``sp_axis``, once refused, is accepted since seq_parallel was
    ported: the module keeps the group it names (rings over real groups
    are ``tests/test_torch_seq_parallel.py``'s) and builds the weights it
    builds without one."""
    from znicz_torch.attention import MultiHeadAttention
    from znicz_torch.core import prng

    mods = []
    for sp_axis in ("sp", None):
        prng.reset(1013)
        mods.append(MultiHeadAttention(name="m", sp_axis=sp_axis))
        mods[-1].build((2, 4, 8), CPU)
    assert mods[0].sp_axis == "sp" and mods[0]._sp_mesh is None
    for k in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(_np(getattr(mods[0], k)),
                                      _np(getattr(mods[1], k)))


def _serving_pair(seed=71):
    """The reference MHA unit and the port's module on the same
    parameters: (reference unit, its params, port module, x)."""
    x = _input((2, 6, 8), False, seed)
    kw = {"heads": 2, "causal": True, "residual": True}
    ref = _reference_unit("MultiHeadAttention", kw, x)
    _, unit = _port_unit("MultiHeadAttention", kw, x)
    params = {k: np.asarray(v) for k, v in _ref_params(ref).items()}
    return ref, params, unit.module, x


def test_mha_serving_forms_match_the_reference():
    import jax.numpy as jnp

    ref, params, mod, x = _serving_pair()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx = torch.from_numpy(x)
    with torch.no_grad():
        for got, want in zip(mod.apply_prefill(tx),
                             ref.apply_prefill(jp, jnp.asarray(x))):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       **UNIT_TOL)
        rng = np.random.default_rng(72)
        ctx = 8
        kv = rng.normal(size=(2, ctx, 2, 4)).astype(np.float32)
        vv = rng.normal(size=(2, ctx, 2, 4)).astype(np.float32)
        # row 1's chunk runs past the view: those positions drop
        t0 = np.array([1, 5], np.int32)
        xc = x[:, :4]
        got = mod.apply_prefill_chunk(torch.from_numpy(xc),
                                      torch.from_numpy(kv),
                                      torch.from_numpy(vv),
                                      torch.from_numpy(t0))
        want = ref.apply_prefill_chunk(jp, jnp.asarray(xc), jnp.asarray(kv),
                                        jnp.asarray(vv), t0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **UNIT_TOL)
        t = np.array([2, 7], np.int32)
        got = mod.apply_decode(torch.from_numpy(x[:, :1]),
                               torch.from_numpy(kv), torch.from_numpy(vv),
                               torch.from_numpy(t))
        want = ref.apply_decode(jp, jnp.asarray(x[:, :1]), jnp.asarray(kv),
                                jnp.asarray(vv), t)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **UNIT_TOL)


def test_char_embedding_serving_forms_match_the_reference():
    import jax.numpy as jnp

    kw = {"vocab": 11, "embed": 6, "max_len": 9}
    x = _input((3, 4), True, 73)
    ref = _reference_unit("CharEmbedding", kw, x)
    _, unit = _port_unit("CharEmbedding", kw, x)
    jp = {k: jnp.asarray(v) for k, v in _ref_params(ref).items()}
    mod = unit.module
    t0 = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        _np(mod.apply_offset(torch.from_numpy(x), torch.from_numpy(t0))),
        np.asarray(ref.apply_offset(jp, jnp.asarray(x), t0)))
    tok = x[:, 0]
    t = np.array([0, 8, 12], np.int32)
    np.testing.assert_array_equal(
        _np(mod.apply_decode(torch.from_numpy(tok), torch.from_numpy(t))),
        np.asarray(ref.apply_decode(jp, jnp.asarray(tok), t)))


# -- the reference's attention cases (tests/test_attention.py) ----------------


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_numpy(causal):
    from znicz_torch.ops.attention import attention

    q, k, v = _qkv(31)
    got = _np(attention(*map(torch.from_numpy, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, np_attention(q, k, v, causal=causal),
                               rtol=1e-5, atol=1e-6)


def test_mha_unit_fwd_bwd():
    """The module's forward against a numpy oracle on its own weights,
    and its GD update of ``wo`` against finite differences of the loss
    ``sum(err * y)``."""
    from znicz_torch.attention import GDMultiHeadAttention
    from znicz_torch.memory import Array

    rng = np.random.default_rng(35)
    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    _, unit = _port_unit("MultiHeadAttention",
                         {"heads": 2, "causal": True}, x)
    mha = unit.module
    unit.run()
    out = _np(unit.output.devmem)
    w = {k: _np(getattr(mha, k)).copy() for k in ("wq", "wk", "wv", "wo")}
    q = (x @ w["wq"]).reshape(2, 6, 2, 4)
    k = (x @ w["wk"]).reshape(2, 6, 2, 4)
    v = (x @ w["wv"]).reshape(2, 6, 2, 4)
    want = np_attention(q, k, v, causal=True).reshape(2, 6, 8) @ w["wo"]
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    gd = GDMultiHeadAttention(None, name="mhagd", forward=unit,
                              learning_rate=1.0, need_err_input=True)
    err = rng.normal(size=out.shape).astype(np.float32)
    gd.err_output = Array(err)
    gd.initialize(device=CPU)
    gd.run()
    dw = w["wo"] - _np(mha.wo)

    def loss(wo):
        with torch.no_grad():
            saved = mha.wo.clone()
            mha.wo.copy_(torch.from_numpy(wo))
            y = mha(torch.from_numpy(x).double().float())
            mha.wo.copy_(saved)
        return float(np.sum(err.astype(np.float64) * _np(y)))

    with torch.no_grad():
        for name in ("wq", "wk", "wv"):
            getattr(mha, name).copy_(torch.from_numpy(w[name]))
    eps = 1e-2
    for idx in [(0, 0), (5, 3)]:
        wp, wm = w["wo"].copy(), w["wo"].copy()
        wp[idx] += eps
        wm[idx] -= eps
        num = (loss(wp) - loss(wm)) / (2 * eps)
        assert abs(num - dw[idx]) < 5e-2 * max(1.0, abs(num)), idx
    assert _np(gd.err_input.devmem).shape == x.shape


def test_attention_causal_offsets():
    """A query block at its global offset over the full keys equals the
    matching rows of full causal attention; explicit offsets match a
    numpy oracle masking ``kpos > qpos``."""
    from znicz_torch.ops.attention import attention

    q, k, v = _qkv(41)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = _np(attention(tq, tk, tv, causal=True))
    blk = _np(attention(tq[:, 4:], tk, tv, causal=True, q_offset=4))
    np.testing.assert_allclose(blk, full[:, 4:], rtol=1e-6, atol=1e-7)
    qb, kb, vb = q[:, 4:], k[:, 2:6], v[:, 2:6]
    got = _np(attention(*map(torch.from_numpy, (qb, kb, vb)), causal=True,
                        q_offset=4, k_offset=2))
    s = np.einsum("bqhd,bkhd->bhqk", qb, kb) / np.sqrt(4)
    qpos, kpos = 4 + np.arange(4), 2 + np.arange(4)
    s = np.where(kpos[None, None, None, :] > qpos[None, None, :, None],
                 -np.inf, s)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhqk,bkhd->bqhd", p, vb),
                               rtol=1e-5, atol=1e-6)


def test_attention_k_valid_mask_length_independence():
    """Masked pad keys carry no probability mass: a row's output over its
    own L real keys equals the unpadded computation, garbage in the
    padded tail included."""
    from znicz_torch.ops.attention import attention

    L, T = 5, 8
    q, k, v = _qkv(43)
    k[:, L:] = 1e3
    v[:, L:] = -1e3
    k_valid = np.zeros((2, T), bool)
    k_valid[:, :L] = True
    got = _np(attention(*map(torch.from_numpy, (q, k, v)),
                        k_valid=torch.from_numpy(k_valid)))
    want = _np(attention(*map(torch.from_numpy, (q, k[:, :L], v[:, :L]))))
    np.testing.assert_allclose(got[:, :L], want[:, :L], rtol=1e-5,
                               atol=1e-6)


def test_gd_mha_grads_match_attention_oracle():
    """The GD unit's applied update (lr 1, no momentum or decay) of every
    projection equals autograd of a loss built directly on
    ``ops.attention.attention``."""
    from znicz_torch.attention import GDMultiHeadAttention
    from znicz_torch.memory import Array
    from znicz_torch.ops.attention import attention

    B, T, H, D, E = 2, 6, 2, 4, 8
    rng = np.random.default_rng(45)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    err = rng.normal(size=(B, T, E)).astype(np.float32)
    _, unit = _port_unit("MultiHeadAttention",
                         {"heads": H, "causal": True}, x)
    mha = unit.module
    w0 = {k: getattr(mha, k).detach().clone()
          for k in ("wq", "wk", "wv", "wo")}
    gd = GDMultiHeadAttention(None, name="g", forward=unit,
                              learning_rate=1.0, gradient_moment=0.0,
                              need_err_input=True)
    gd.err_output = Array(err)
    gd.initialize(device=CPU)
    gd.run()
    params = {k: w.clone().requires_grad_(True) for k, w in w0.items()}
    xt = torch.from_numpy(x)
    qkv = [(xt @ params[n]).reshape(B, T, H, D) for n in ("wq", "wk", "wv")]
    y = attention(*qkv, causal=True).reshape(B, T, H * D) @ params["wo"]
    grads = torch.autograd.grad(torch.sum(torch.from_numpy(err) * y),
                                list(params.values()))
    for (name, w), g in zip(w0.items(), grads):
        np.testing.assert_allclose(_np(w - getattr(mha, name)), _np(g),
                                   rtol=2e-4, atol=1e-6, err_msg=name)


# -- the reference's decode op cases (tests/test_generate.py) -----------------


def test_attention_all_masked_keys_returns_zeros_not_nan():
    from znicz_torch.ops.attention import attention

    q, k, v = _qkv(7, tq=1, tk=6)
    out = _np(attention(*map(torch.from_numpy, (q, k, v)),
                        k_valid=torch.zeros((2, 6), dtype=torch.bool)))
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, np.zeros_like(out))


def test_attention_guard_bit_identical_with_valid_keys():
    """Rows with a valid key equal the unguarded softmax over the valid
    prefix bit for bit: the masked probabilities are exact zeros."""
    from znicz_torch.ops.attention import attention

    q, k, v = map(torch.from_numpy, _qkv(11, b=1, tq=1, tk=6))
    for n_valid in (1, 3, 6):
        k_valid = torch.zeros((1, 6), dtype=torch.bool)
        k_valid[:, :n_valid] = True
        np.testing.assert_array_equal(
            _np(attention(q, k, v, k_valid=k_valid)),
            _np(attention(q, k[:, :n_valid], v[:, :n_valid])))


def test_decode_attention_matches_causal_row():
    """``cache_append`` + ``decode_attention`` at fill ``t`` equals row
    ``t`` of the full causal forward (a ~1-ulp band: another reduction
    shape)."""
    from znicz_torch.ops.attention import (attention, cache_append,
                                           decode_attention)

    S, C = 5, 8
    q, k, v = map(torch.from_numpy, _qkv(13, b=1, tq=S, tk=S))
    full = _np(attention(q, k, v, causal=True))
    kc = torch.zeros((1, C, 2, 4))
    vc = torch.zeros((1, C, 2, 4))
    for t in range(S):
        tt = torch.tensor([t], dtype=torch.int32)
        kc = cache_append(kc, k[:, t], tt)
        vc = cache_append(vc, v[:, t], tt)
        step = _np(decode_attention(q[:, t:t + 1], kc, vc, tt))
        np.testing.assert_allclose(step[:, 0], full[:, t], rtol=1e-6,
                                   atol=1e-6)


def test_paged_decode_attention_bit_exact_vs_contiguous():
    """The paged path is the contiguous one plus a pure gather: bit-equal
    to ``decode_attention`` over the gathered views; an append lands at
    (``table[i, t // ps]``, ``t % ps``) and a pad row's scratch page
    aliases no real one."""
    from znicz_torch.ops.attention import (decode_attention, paged_append,
                                           paged_decode_attention,
                                           paged_gather)

    rng = np.random.default_rng(17)
    ps, n_pages, h, d = 4, 6, 2, 4
    pool_k = torch.from_numpy(
        rng.normal(size=(n_pages + 1, ps, h, d)).astype(np.float32))
    pool_v = torch.from_numpy(
        rng.normal(size=(n_pages + 1, ps, h, d)).astype(np.float32))
    table = torch.tensor([[3, 1], [4, n_pages]], dtype=torch.int32)
    t = torch.tensor([6, 2], dtype=torch.int32)
    gk = _np(paged_gather(pool_k, table))
    np.testing.assert_array_equal(gk[0, :ps], _np(pool_k[3]))
    np.testing.assert_array_equal(gk[0, ps:], _np(pool_k[1]))
    q = torch.from_numpy(rng.normal(size=(2, 1, h, d)).astype(np.float32))
    np.testing.assert_array_equal(
        _np(paged_decode_attention(q, pool_k, pool_v, table, t)),
        _np(decode_attention(q, paged_gather(pool_k, table),
                             paged_gather(pool_v, table), t)))
    row = torch.from_numpy(rng.normal(size=(2, h, d)).astype(np.float32))
    out = _np(paged_append(pool_k, table, row, t))
    np.testing.assert_array_equal(out[1, 6 % ps], _np(row[0]))
    np.testing.assert_array_equal(out[4, 2], _np(row[1]))
    np.testing.assert_array_equal(out[3], _np(pool_k[3]))
