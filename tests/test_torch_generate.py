"""Generation serving of the port (``znicz_torch/serving/``: the paged
``GenerationRunner``, ``PrefixCache``, ``GenerationScheduler``, the
frontend's ``generate`` plane, the client's ``generate`` API) on the CPU:
the cases of the reference's ``tests/test_generate.py`` (its web panel
aside: telemetry, ROADMAP A.9) and cross-package ones:

  - the page pool's refcounts and the prefix index's eviction;
  - paged decode against the full forward and chunked prefill against a
    monolithic one, within the reference's band (``BAND``); a prefix hit
    bit-equal to a cold prefill; copy-on-write leaving the shared page's
    bytes alone; every real row's (page, offset) write unique in a
    dispatch and never on a shared page;
  - the scheduler: continuous batching, refusals, deadlines, page
    pressure, the residue after every ending, greedy tokens equal across
    ``on_device_sampling``, log-probabilities and logits;
  - the service end to end, generation disabled refused readably, a swap
    in the middle of generations (the pools stay, the family is entered
    again), a failed compute loop answering every live generation;
  - the reference's ``GenerationRunner`` and the port's on the same
    carried-across charlm weights: prefill and decode logits to
    ``CROSS_TOL``, 20 greedy tokens equal; the two schedulers' replies on
    one scripted stream, on-device and host sampling both;
  - a chaos soak and the residue audit (``slow``, as the reference's).
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from test_torch_serving_seq import _charlm_wf, _ref_charlm_wf

VOCAB = 32
#: paged compute against the full forward (different executables): the
#: reference's band (tests/test_generate.py)
BAND = {"rtol": 1e-5, "atol": 1e-6}
#: the two packages' runners on the same weights and inputs
CROSS_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small models (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen_runner(wf, page_size=8, num_pages=16, slots=2, prefill_chunk=8,
                prefix_cache=True):
    from znicz_torch.serving.model import ModelRunner

    runner = ModelRunner(wf)
    return runner.enable_generation(page_size=page_size,
                                    num_pages=num_pages, slots=slots,
                                    prefill_chunk=prefill_chunk,
                                    prefix_cache=prefix_cache)


def _greedy(gen, prompt, n_new, pages=None):
    """One request driven by hand through the paged runner: chunked
    prefill, then greedy decode.  Returns (tokens, page list)."""
    prompt = np.asarray(prompt).reshape(-1)
    ps, c = gen.page_size, gen.prefill_chunk
    pages = [] if pages is None else pages
    t0 = len(pages) * ps if pages else 0
    t0 = min(t0, len(prompt) - 1)
    tok = None
    while t0 < len(prompt):
        n = min(c, len(prompt) - t0)
        need = -(-(t0 + n) // ps)
        while len(pages) < need:
            pages.append(gen.alloc_page())
        x = np.zeros((1, c), np.uint8)
        x[0, :n] = prompt[t0:t0 + n]
        tok, _, _, _ = gen.prefill(x, [t0], [n], [pages], [0.0], [0], [0])
        t0 += n
    toks = [int(tok[0])]
    t = len(prompt)
    for _ in range(n_new - 1):
        if t % ps == 0:
            pages.append(gen.alloc_page())
        tok, _, _, _ = gen.decode([pages], [toks[-1]], [t], [0.0], [0], [0])
        toks.append(int(tok[0]))
        t += 1
    return toks, pages


@contextlib.contextmanager
def _generate_config(**extra):
    """The generation plane on for a server, every key deleted after."""
    from znicz_torch.core.config import root

    values = {"enabled": True, "page_size": 8, "slots": 4, **extra}
    root.common.serving.seq.rungs = [8, 32]
    root.common.serving.generate.update(values)
    try:
        yield
    finally:
        for key in values:
            delattr(root.common.serving.generate, key)
        delattr(root.common.serving.seq, "rungs")


def _run_to_completion(sched, max_rounds=400):
    replies = []
    for _ in range(max_rounds):
        if not sched.work_available():
            break
        _, reps = sched.step()
        replies.extend(reps)
    return replies


def _finals(replies):
    return {r["req_id"]: r for _, r in replies if not r.get("partial")}


# -- the page pool and the prefix index ----------------------------------------


def test_page_pool_refcount_accounting():
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=4, slots=2,
                    prefix_cache=False)
    assert g.page_rungs == (1, 2, 4)
    assert g.max_ctx == 32
    assert g.executables() == ((len(g.prefill_rungs)
                                + len(g.decode_rungs)) * 3 + 1)
    assert len(g.keys()) == g.executables()
    pages = [g.alloc_page() for _ in range(4)]
    assert sorted(pages) == [0, 1, 2, 3] and g.scratch not in pages
    assert g.alloc_page() is None
    assert g.pages_active() == 4 and g.occupancy() == 1.0
    g.addref(pages[0])
    g.decref(pages[0])
    assert g.pages_active() == 4
    g.release_pages(pages)
    assert g.pages_active() == 0 and g.pages_leaked() == 0
    st = g.stats()
    assert st["pages_free"] == 4 and st["pages_leaked"] == 0
    p = g.alloc_page()
    g.decref(p)
    with pytest.raises(AssertionError):
        g.decref(p)


def _refusal(case):
    """A ModelRunner (and its enable_generation keywords) that
    ``case`` makes refuse generation."""
    from test_torch_planner import SAMPLE, tiny_layers
    from znicz_torch.serving.model import ModelRunner
    from znicz_torch.standard_workflow import StandardWorkflow

    kw = dict(page_size=8, num_pages=16, slots=2, prefill_chunk=8)
    if case == "not_a_sequence_model":
        return ModelRunner(StandardWorkflow(tiny_layers(), SAMPLE,
                                            device="cpu")), kw
    runner = ModelRunner(_charlm_wf(32))
    embed, mha, ffn, head = runner.workflow.forwards
    if case == "mesh":
        runner.mesh = object()
    elif case == "no_softmax_head":
        runner.workflow.forwards = [embed, mha, ffn]
    elif case == "non_causal":
        mha.causal = False
    elif case == "no_decode_form":
        from znicz_torch.all2all import All2All

        runner.workflow.forwards = [embed, mha, All2All(name="fc"), head]
    elif case == "no_attention":
        runner.workflow.forwards = [embed, ffn, head]
    else:
        kw.update({"page_size": dict(page_size=1),
                   "small_pool": dict(num_pages=3),
                   "chunk": dict(prefill_chunk=0),
                   "slots": dict(slots=0)}[case])
    return runner, kw


@pytest.mark.parametrize("case,message", [
    ("mesh", "single-device for now"),
    ("not_a_sequence_model", "needs a CharEmbedding first unit"),
    ("no_softmax_head", "per-position softmax head"),
    ("non_causal", "requires causal attention"),
    ("no_decode_form", "has no decode form"),
    ("no_attention", "at least one MultiHeadAttention"),
    ("page_size", "page_size must be >= 2"),
    ("small_pool", "cannot hold one full context window"),
    ("chunk", "prefill_chunk must be >= 1"),
    ("slots", ">= 1 concurrency slot")])
def test_generation_refusals_are_the_references(case, message):
    """Each stack or geometry the reference refuses, refused with its
    message."""
    runner, kw = _refusal(case)
    with pytest.raises(ValueError, match=message):
        runner.enable_generation(**kw)
    assert runner.gen_runner is None


def test_prefix_index_eviction_under_pressure():
    """Idle index-held pages are reclaimed LRU-first when the pool runs
    dry; a page shared with a live request is never taken."""
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=4, slots=2)
    rng = np.random.default_rng(19)
    p1 = rng.integers(1, VOCAB, size=8)
    _, pages1 = _greedy(g, p1, 1)
    g.prefix.register(p1, pages1)
    g.release_pages(pages1)
    assert g.stats()["prefix_pages"] == 1
    assert g.pages_active() == 1
    held, covered = g.prefix.lookup(p1)
    assert covered == 8
    others = [g.alloc_page() for _ in range(3)]
    assert all(p is not None for p in others)
    assert g.alloc_page() is None
    assert g.stats()["prefix_pages"] == 1
    g.release_pages(held)
    got = g.alloc_page()
    assert got is not None
    assert g.stats()["prefix_pages"] == 0
    assert g.prefix_counts()["evictions"] >= 1
    g.release_pages(others + [got])
    assert g.pages_active() == 0 and g.pages_leaked() == 0


# -- paged decode and chunked prefill against the scoring forward ------------


def test_paged_decode_parity_with_full_forward():
    """Greedy decode through the pool across page boundaries (1 -> 4
    pages) against the full forward teacher-forced on the same prefix,
    at every step, within ``BAND``."""
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2)
    runner = g.runner
    rng = np.random.default_rng(17)
    prompt = rng.integers(1, VOCAB, size=5).astype(np.uint8)
    pages = [g.alloc_page()]
    x = np.zeros((1, 8), np.uint8)
    x[0, :5] = prompt
    tok, _, logits, _ = g.prefill(x, [0], [5], [pages], [0.0], [0], [0])
    toks = [int(tok[0])]
    steps = [logits[0]]
    t = 5
    for _ in range(20):
        if t % g.page_size == 0:
            pages.append(g.alloc_page())
        tok, _, logits, _ = g.decode([pages], [toks[-1]], [t], [0.0], [0],
                                     [0])
        toks.append(int(tok[0]))
        steps.append(logits[0])
        t += 1
    assert len(pages) == 4
    prefix = list(prompt) + toks[:-1]
    xb = np.zeros((1, 32), np.uint8)
    xb[0, :len(prefix)] = prefix
    full = runner.infer(xb)[0]
    for i, row in enumerate(steps):
        np.testing.assert_allclose(row, full[len(prompt) - 1 + i], **BAND)
    g.release_pages(pages)
    assert g.pages_active() == 0 and g.pages_leaked() == 0


def test_chunked_prefill_matches_monolithic():
    """A 24-token prompt in three 8-token chunks gives the next-token
    logits of one full forward over it, within ``BAND``."""
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2)
    rng = np.random.default_rng(23)
    prompt = rng.integers(1, VOCAB, size=24).astype(np.uint8)
    pages = []
    for i in range(3):
        pages.append(g.alloc_page())
        x = np.zeros((1, 8), np.uint8)
        x[0] = prompt[i * 8:(i + 1) * 8]
        tok, _, logits, _ = g.prefill(x, [i * 8], [8], [pages], [0.0], [0],
                                      [0])
    xb = np.zeros((1, 32), np.uint8)
    xb[0, :24] = prompt
    full = g.runner.infer(xb)[0]
    np.testing.assert_allclose(logits[0], full[23], **BAND)
    assert int(tok[0]) == int(np.argmax(full[23]))
    g.release_pages(pages)


def test_prefix_hit_bit_exact_vs_cold_prefill():
    """A prompt whose full pages hit the index decodes bit-identically to
    its cold prefill (``prefill_chunk == page_size``): logits equal to
    the byte."""
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2,
                    prefill_chunk=8)
    rng = np.random.default_rng(29)
    prompt = rng.integers(1, VOCAB, size=20).astype(np.uint8)

    def run(expect_hit):
        hits0 = g.prefix_counts()["hits"]
        pages, covered = g.prefix.lookup(prompt)
        assert (covered == 16) == expect_hit
        assert (g.prefix_counts()["hits"] == hits0 + 1) == expect_hit
        toks, rows = [], []
        t0 = covered
        while t0 < 20:
            n = min(8, 20 - t0)
            while len(pages) < -(-(t0 + n) // 8):
                pages.append(g.alloc_page())
            x = np.zeros((1, 8), np.uint8)
            x[0, :n] = prompt[t0:t0 + n]
            tok, _, logits, _ = g.prefill(x, [t0], [n], [pages], [0.0], [0],
                                          [0])
            t0 += n
        toks.append(int(tok[0]))
        rows.append(logits[0])
        t = 20
        for _ in range(6):
            if t % 8 == 0:
                pages.append(g.alloc_page())
            tok, _, logits, _ = g.decode([pages], [toks[-1]], [t], [0.0],
                                         [0], [0])
            toks.append(int(tok[0]))
            rows.append(logits[0])
            t += 1
        g.prefix.register(prompt, pages)
        return toks, rows, pages

    cold_t, cold_r, cold_p = run(expect_hit=False)
    g.release_pages(cold_p)
    hit_t, hit_r, hit_p = run(expect_hit=True)
    g.release_pages(hit_p)
    assert cold_t == hit_t
    for a, b in zip(cold_r, hit_r):
        np.testing.assert_array_equal(a, b)
    assert g.prefix_counts()["tokens_avoided"] == 16
    assert g.pages_leaked() == 0


def test_cow_divergence_keeps_shared_pages_immutable():
    """A second request claiming a full shared page and writing into it
    writes into a copy: the donor's page bytes never change."""
    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2)
    rng = np.random.default_rng(31)
    prompt = rng.integers(1, VOCAB, size=8).astype(np.uint8)
    toks_a, pages_a = _greedy(g, prompt, 4)
    g.prefix.register(prompt, pages_a)
    shared = pages_a[0]
    layer = next(iter(g.pk))
    before_k = g.pk[layer][shared].clone()
    pages_b, covered = g.prefix.lookup(prompt)
    assert covered == 8 and pages_b == [shared]
    fresh = g.alloc_page()
    g.copy_page(shared, fresh)
    g.decref(shared)
    pages_b[0] = fresh
    x = np.zeros((1, 8), np.uint8)
    x[0, 0] = prompt[7]
    tok_b, _, _, _ = g.prefill(x, [7], [1], [pages_b], [0.0], [0], [0])
    toks_b = [int(tok_b[0])]
    t = 8
    for _ in range(3):
        if t % 8 == 0:
            pages_b.append(g.alloc_page())
        tok_b, _, _, _ = g.decode([pages_b], [toks_b[-1]], [t], [0.0], [0],
                                  [0])
        toks_b.append(int(tok_b[0]))
        t += 1
    assert torch.equal(g.pk[layer][shared], before_k)
    assert toks_b == toks_a
    assert g.page_ref[fresh] == 1
    g.release_pages(pages_a)
    g.release_pages(pages_b)
    assert g.pages_active() == 1 and g.pages_leaked() == 0
    assert g.stats()["prefix_pages"] == 1


def test_real_writes_unique_and_never_on_a_shared_page():
    """In every prefill and decode dispatch of a scheduler run (shared
    prefixes, copy-on-write, co-batched rows), the (page, offset) each
    real token writes is unique in the dispatch, is not scratch, and is
    on a page only its request holds: in-place writes can collide only on
    the scratch page."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=24, slots=2)
    sched = GenerationScheduler(g, max_new_cap=16)
    writes = []
    prefill_async, decode_async = g.prefill_async, g.decode_async

    def check(slots):
        assert len(set(slots)) == len(slots), slots
        for page, _ in slots:
            assert page != g.scratch and g.page_ref[page] == 1, page
        writes.append(len(slots))

    def prefill(x, t0s, n_new, page_lists, *rest):
        check([(pages[(t0 + j) // g.page_size], (t0 + j) % g.page_size)
               for pages, t0, n in zip(page_lists, t0s, n_new)
               for j in range(n)])
        return prefill_async(x, t0s, n_new, page_lists, *rest)

    def decode(page_lists, tokens, ts, *rest):
        check([(pages[t // g.page_size], t % g.page_size)
               for pages, t in zip(page_lists, ts)])
        return decode_async(page_lists, tokens, ts, *rest)

    g.prefill_async, g.decode_async = prefill, decode
    rng = np.random.default_rng(7)
    shared = rng.integers(1, VOCAB, size=16).astype(np.uint8)
    for rid in range(8):
        # odd ids share the prefix; 1, 3 and 7 are the prefix alone (a
        # full hit: the last prompt token's write copies the shared page)
        tail = rng.integers(1, VOCAB, size=(rid // 2) % 3 if rid % 4 == 1
                            else 0).astype(np.uint8)
        prompt = np.concatenate([shared, tail]) if rid % 2 else \
            rng.integers(1, VOCAB, size=3 + rid)
        assert sched.submit(GenSeq(prompt, 6, req_id=rid)) is None
    finals = _finals(_run_to_completion(sched))
    assert len(finals) == 8 and all(r["ok"] for r in finals.values())
    assert sched.cow_copies > 0 and g.stats()["prefix_hits"] > 0
    assert sum(writes) > 0 and g.pages_leaked() == 0


# -- the continuous-batching scheduler ------------------------------------------


def test_scheduler_continuous_batching():
    """Mixed generations through the scheduler alone: co-batched decode
    ticks, chunked prefill of a long prompt, release mid-batch,
    truncation at the context window, resend dedup, and the same tokens
    on a re-run (which rides the prefix cache)."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=24, slots=4)
    sched = GenerationScheduler(g, max_new_cap=64)
    rng = np.random.default_rng(19)

    def seqs():
        return [GenSeq(rng.integers(1, VOCAB, size=3), 4, req_id=1),
                GenSeq(rng.integers(1, VOCAB, size=5), 12, req_id=2),
                GenSeq(rng.integers(1, VOCAB, size=7), 6, temperature=0.8,
                       seed=41, req_id=3),
                GenSeq(rng.integers(1, VOCAB, size=6), 30, req_id=4),
                GenSeq(rng.integers(1, VOCAB, size=20), 4, req_id=5)]

    first = seqs()
    for s in first:
        assert sched.submit(s) is None
    assert sched.submit(GenSeq(first[0].prompt, 4, req_id=1)) is None
    assert sched.gen_dedup == 1
    finals = _finals(_run_to_completion(sched))
    assert set(finals) == {1, 2, 3, 4, 5}
    assert all(r["ok"] for r in finals.values())
    assert len(finals[1]["tokens"]) == 4
    assert len(finals[2]["tokens"]) == 12
    assert "truncated" in finals[4] and len(finals[4]["tokens"]) < 30
    assert sched.gen_truncated == 1
    assert sched.prefill_batches >= 3
    assert g.pages_leaked() == 0
    assert g.pages_active() == g.stats()["prefix_pages"]
    assert sched.decode_batches > 0
    hits0 = g.stats()["prefix_hits"]
    rng = np.random.default_rng(19)
    for s in seqs():
        assert sched.submit(s) is None
    finals2 = _finals(_run_to_completion(sched))
    for rid in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(finals[rid]["tokens"],
                                      finals2[rid]["tokens"])
    assert g.stats()["prefix_hits"] > hits0


def test_scheduler_refusals_and_deadline():
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2)
    sched = GenerationScheduler(g, max_new_cap=16)
    ref = sched.submit(GenSeq(np.ones(33, np.uint8), 4))
    assert ref is not None and "context window" in ref \
        and ref.policy == "oversized"
    ref = sched.submit(GenSeq(np.ones(3, np.uint8), 17))
    assert ref is not None \
        and "root.common.serving.generate.max_new_tokens" in ref
    s = GenSeq(np.ones(3, np.uint8), 4, deadline_s=-0.01)
    assert sched.submit(s) is None
    _, reps = sched.step()
    timed = [r for _, r in reps if r.get("timed_out")]
    assert len(timed) == 1 and timed[0]["policy"] == "deadline"
    assert g.pages_active() == 0


def test_scheduler_page_pressure_flood_no_leaks():
    """A flood against a pool for one request and a tight pending bound:
    overflow is shed, everything admitted finishes (page pressure stalls
    rows, never deadlocks), a deadline mid-generation ships its partial
    and releases its pages, and the pool comes back whole."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=4, slots=2,
                    prefix_cache=False)
    sched = GenerationScheduler(g, max_new_cap=8, pending_bound=3)
    rng = np.random.default_rng(23)

    def seq(rid, max_new=2, size=3):
        return GenSeq(rng.integers(1, VOCAB, size=size).astype(np.uint8),
                      max_new, req_id=rid)

    for rid in (1, 2, 3):
        assert sched.submit(seq(rid)) is None
    ref = sched.submit(seq(4))
    assert ref is not None and ref.policy == "shed"
    assert "generation queue at bound" in ref
    assert sched.gen_refused == 1
    finals = _finals(_run_to_completion(sched))
    assert set(finals) == {1, 2, 3}
    assert all(r["ok"] and len(r["tokens"]) == 2 for r in finals.values())
    assert g.pages_active() == 0
    a, b = seq(10, max_new=6, size=9), seq(11, max_new=6, size=9)
    assert sched.submit(a) is None and sched.submit(b) is None
    for _ in range(200):
        sched.step()
        if b.pages:
            break
    assert b.pages
    b.t_deadline = 1e-9
    _, reps = sched.step()
    timed = [r for _, r in reps if r.get("timed_out")]
    assert len(timed) == 1 and timed[0]["req_id"] == 11
    assert timed[0]["policy"] == "deadline"
    _run_to_completion(sched)
    assert g.pages_active() == 0 and g.pages_leaked() == 0
    assert sorted(g._free_pages) == list(range(g.num_pages))
    assert not g.page_ref.any()
    assert sched.submit(seq(20)) is None
    finals = _finals(_run_to_completion(sched))
    assert finals[20]["ok"]
    assert g.pages_active() == 0


@pytest.mark.slow
def test_page_refcounts_return_to_prefix_residue():
    """With sharing on, after every ending (ok, deadline partial, drain)
    the pool holds exactly the shared-prefix residue: every allocated page
    refcount 1 and index-held, none leaked."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=24, slots=4)
    sched = GenerationScheduler(g, max_new_cap=16)
    rng = np.random.default_rng(37)
    shared = rng.integers(1, VOCAB, size=16).astype(np.uint8)

    def residue_ok():
        st = g.stats()
        assert st["pages_leaked"] == 0
        assert st["pages_active"] == st["prefix_pages"]
        held = [p for p in range(g.num_pages) if g.page_ref[p] > 0]
        assert all(g.page_ref[p] == 1 for p in held)
        assert len(held) == st["prefix_pages"]

    for rid in (1, 2):
        tail = rng.integers(1, VOCAB, size=3).astype(np.uint8)
        assert sched.submit(GenSeq(np.concatenate([shared, tail]), 3,
                                   req_id=rid)) is None
    finals = _finals(_run_to_completion(sched))
    assert finals[1]["ok"] and finals[2]["ok"]
    residue_ok()
    s = GenSeq(np.concatenate(
        [shared, rng.integers(1, VOCAB, size=2).astype(np.uint8)]), 12,
        req_id=3)
    assert sched.submit(s) is None
    for _ in range(50):
        sched.step()
        if s.tokens:
            break
    s.t_deadline = 1e-9
    _run_to_completion(sched)
    residue_ok()
    assert g.stats()["prefix_hits"] >= 1
    assert sched.submit(GenSeq(shared, 8, req_id=4)) is None
    sched.step()
    reps = sched.drain()
    assert any(r.get("policy") == "draining" for _, r in reps)
    residue_ok()


def test_on_device_vs_host_sampling_greedy_bit_identical():
    """``on_device_sampling`` changes only what is fetched: greedy tokens
    are bit-identical across it, and the device path fetches a fraction
    of the bytes."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2,
                    prefix_cache=False)
    rng = np.random.default_rng(41)
    prompt = rng.integers(1, VOCAB, size=5).astype(np.uint8)

    def run(on_device):
        sched = GenerationScheduler(g, max_new_cap=16,
                                    on_device_sampling=on_device)
        assert sched.submit(GenSeq(prompt, 8, req_id=1)) is None
        finals = _finals(_run_to_completion(sched))
        return finals[1]["tokens"], sched.fetch_bytes

    dev_toks, dev_bytes = run(on_device=True)
    host_toks, host_bytes = run(on_device=False)
    np.testing.assert_array_equal(dev_toks, host_toks)
    assert dev_bytes * 4 <= host_bytes
    assert g.pages_active() == 0 and g.pages_leaked() == 0


def test_scheduler_logprobs_and_logits():
    """``return_logprobs`` ships one float a token (both sampling paths
    agree within float32 against float64), ``return_logits`` works with
    in-graph sampling on, and the log-probability is the log-softmax of
    the shipped row."""
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    g = _gen_runner(_charlm_wf(32), page_size=8, num_pages=16, slots=2,
                    prefix_cache=False)
    rng = np.random.default_rng(43)
    prompt = rng.integers(1, VOCAB, size=5).astype(np.uint8)

    def run(on_device):
        sched = GenerationScheduler(g, max_new_cap=16,
                                    on_device_sampling=on_device)
        assert sched.submit(GenSeq(prompt, 5, req_id=1, return_logprobs=True,
                                   return_logits=True)) is None
        return _finals(_run_to_completion(sched))[1]

    a = run(on_device=True)
    b = run(on_device=False)
    assert a["logprobs"].shape == (5,) and a["logits"].shape == (5, VOCAB)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(a["logprobs"], b["logprobs"], **BAND)
    z = a["logits"][0].astype(np.float64)
    z -= z.max()
    want = z[a["tokens"][0]] - np.log(np.exp(z).sum())
    np.testing.assert_allclose(a["logprobs"][0], want, **BAND)
    assert g.pages_active() == 0


# -- the service -----------------------------------------------------------------


@contextlib.contextmanager
def _gen_service(**extra):
    from znicz_torch.serving import InferenceClient, InferenceServer

    with _generate_config(**extra):
        srv = InferenceServer(_charlm_wf(32), max_batch=4, max_delay_ms=1.0,
                              warmup=False).start()
    cli = InferenceClient(srv.endpoint, timeout=120)
    try:
        yield srv, cli
    finally:
        cli.close()
        srv.stop()


def test_e2e_generate_service():
    """The ``generate`` request kind end to end: greedy and seeded
    determinism over the wire, streamed partials, log-probabilities,
    refusals naming the knob, neighbour invisibility, prefix reuse,
    truncation, stats, and no family entry on a repeated mixed stream."""
    from znicz_torch.serving.client import InferenceError

    rng = np.random.default_rng(23)
    with _gen_service() as (srv, cli):
        prompt = rng.integers(1, VOCAB, size=5).astype(np.uint8)
        a = cli.generate(prompt, max_new_tokens=6)
        b = cli.generate(prompt, max_new_tokens=6)
        assert a["prompt_len"] == 5 and len(a["tokens"]) == 6
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        s1 = cli.generate(prompt, 6, temperature=0.9, top_k=8, seed=37)
        s2 = cli.generate(prompt, 6, temperature=0.9, top_k=8, seed=37)
        np.testing.assert_array_equal(s1["tokens"], s2["tokens"])
        got = []
        rid = cli.submit_generate(prompt, 6, stream=True,
                                  on_token=lambda t, i: got.append((i, t)))
        fin = cli.result(rid)
        assert [i for i, _ in got] == list(range(6))
        np.testing.assert_array_equal([t for _, t in got], fin["tokens"])
        lp = cli.generate(prompt, 4, return_logprobs=True)
        assert lp["logprobs"].shape == (4,)
        assert np.all(lp["logprobs"] <= 0)
        rid_p = cli.submit_generate(prompt, 6)
        rids = [cli.submit_generate(
                    rng.integers(1, VOCAB, size=4).astype(np.uint8), 6,
                    temperature=1.1, seed=100 + k) for k in range(2)]
        reps = {r: cli.result(r) for r in [rid_p] + rids}
        np.testing.assert_array_equal(reps[rid_p]["tokens"], a["tokens"])
        long_p = rng.integers(1, VOCAB, size=26).astype(np.uint8)
        st0 = srv.stats()["generate"]
        r1 = cli.generate(long_p, 4)
        st1 = srv.stats()["generate"]
        r2 = cli.generate(long_p, 4)
        st2 = srv.stats()["generate"]
        np.testing.assert_array_equal(r1["tokens"], r2["tokens"])
        cold = st1["prefill_tokens"] - st0["prefill_tokens"]
        warm = st2["prefill_tokens"] - st1["prefill_tokens"]
        assert cold == 26 and warm <= 2, (cold, warm)
        with pytest.raises(InferenceError, match="context window"):
            cli.generate(np.ones(33, np.uint8), 4)
        with pytest.raises(InferenceError,
                           match="generate.max_new_tokens"):
            cli.generate(prompt, 10 ** 6)
        t = cli.generate(prompt, 40)
        assert t.get("truncated") and len(t["tokens"]) < 40
        st = srv.stats()["generate"]
        assert st["gen_finished"] >= 8
        assert st["generated_tokens"] >= 8 * 6
        assert st["pages_leaked"] == 0
        assert st["pages_active"] == st["prefix_pages"]
        assert st["prefix_hits"] >= 1
        assert st["inter_token_p99_ms"] is not None
        warm_c = srv.runner.compiles
        cache = srv.runner.graph_cache_size()
        cli.generate(prompt, 6)
        cli.generate(prompt, 6, temperature=0.9, top_k=8, seed=37)
        cli.generate(prompt, 40)
        cli.generate(long_p, 4)
        assert srv.runner.compiles == warm_c
        assert srv.runner.graph_cache_size() == cache


def test_wake_ends_an_idle_wait_on_the_scoring_queue():
    """``DynamicBatcher.wake`` (what an accepted generation calls) ends a
    compute loop's wait for a scoring request: ``next_batch`` returns None
    long before its timeout, and a later wait is not cut short by an old
    wake."""
    import threading

    from znicz_torch.serving.batcher import DynamicBatcher, Request

    b = DynamicBatcher(4)
    got = []
    waiter = threading.Thread(
        target=lambda: got.append(b.next_batch(timeout=600)))
    waiter.start()
    t0 = time.perf_counter()
    while waiter.is_alive() and time.perf_counter() - t0 < 60:
        b.wake()
        waiter.join(0.05)
    assert not waiter.is_alive() and got == [None]
    assert b.submit(Request(np.ones((1, 4), np.float32), 1)) is None
    batch = b.next_batch(timeout=60)
    assert batch is not None and len(batch) == 1


def test_generate_disabled_is_refused_readably():
    from znicz_torch.core.config import root
    from znicz_torch.serving import InferenceClient, InferenceServer
    from znicz_torch.serving.client import InferenceError

    root.common.serving.seq.rungs = [8, 32]
    try:
        srv = InferenceServer(_charlm_wf(32), max_batch=4, max_delay_ms=1.0,
                              warmup=False).start()
        cli = InferenceClient(srv.endpoint, timeout=30)
        try:
            with pytest.raises(InferenceError,
                               match="generate.*enabled|enabled.*generate"):
                cli.generate(np.ones(3, np.uint8), 4)
        finally:
            cli.close()
            srv.stop()
    finally:
        delattr(root.common.serving.seq, "rungs")


def test_warmup_enters_the_generation_family_and_the_proof_holds():
    """At warmup the family holds every ladder bucket and every
    generation executable, the proof expects both, and traffic adds
    none."""
    from znicz_torch.serving import InferenceClient, InferenceServer

    with _generate_config():
        srv = InferenceServer(_charlm_wf(32), max_batch=4,
                              max_delay_ms=1.0).start()
    cli = InferenceClient(srv.endpoint, timeout=120)
    try:
        gen = srv.gen_sched.gen
        expected = len(srv.batcher.ladder.buckets()) + gen.executables()
        assert srv.warm_report["ok"] and srv.warm_report["expected"] \
            == expected == srv.runner.compiles \
            == srv.runner.graph_cache_size()
        assert gen.graph_cache_size() == gen.executables()
        cli.generate(np.arange(1, 12, dtype=np.uint8), 8)
        cli.infer(np.ones((2, 5), np.uint8))
        assert srv.runner.compiles == expected
    finally:
        cli.close()
        srv.stop()


def test_swap_mid_generation_keeps_the_pools(tmp_path):
    """A swap while generations run: the new tree's family is entered
    (ladder and generation keys), the pools keep their addresses,
    sequences in flight finish under the new generation's stamp, and
    greedy tokens after the swap equal a fresh service's on the new
    weights."""
    from znicz_torch.nn_units import params_of
    from znicz_torch.serving import InferenceClient, InferenceServer
    from znicz_torch.snapshotter import write_host_pickle

    with _gen_service() as (srv, cli):
        gen = srv.gen_sched.gen
        ptrs = {n: t.data_ptr() for n, t in gen.pk.items()}
        tree = {f.name: {k: 1.5 * p.numpy() for k, p in params_of(f).items()}
                for f in _charlm_wf(32).forwards if f.has_weights}
        path = str(tmp_path / "gen2.pickle.gz")
        write_host_pickle(path, {"units": tree, "velocities": {},
                                 "epoch": 3})
        prompt = np.arange(1, 8, dtype=np.uint8)
        before = cli.generate(prompt, 6)
        assert before["gen"] == 1
        rids = [cli.submit_generate(prompt, 24) for _ in range(3)]
        cli.swap(path)
        t0 = time.time()
        while srv.runner.generation != 2:
            assert time.time() - t0 < 120, "the swap did not flip"
            time.sleep(0.01)
        finals = [cli.result(r) for r in rids]
        assert all(f["ok"] for f in finals)
        after = cli.generate(prompt, 6)
        assert after["gen"] == 2
        assert {n: t.data_ptr() for n, t in gen.pk.items()} == ptrs
        assert gen.graph_cache_size() == gen.executables()
        assert gen.pages_leaked() == 0
        with _generate_config():
            fresh = InferenceServer(_charlm_wf(32), snapshot=path,
                                    max_batch=4, warmup=False).start()
        cli2 = InferenceClient(fresh.endpoint, timeout=120)
        try:
            np.testing.assert_array_equal(
                after["tokens"], cli2.generate(prompt, 6)["tokens"])
        finally:
            cli2.close()
            fresh.stop()


def test_a_dead_compute_loop_answers_every_live_generation():
    """When the compute loop dies, each queued and live generation gets a
    readable failure, not silence."""
    from znicz_torch.serving.client import InferenceError

    with _gen_service() as (srv, cli):
        gen = srv.gen_sched.gen

        def boom(*args, **kwargs):
            raise RuntimeError("injected decode fault")

        gen.decode_async = boom
        rids = [cli.submit_generate(np.arange(1, 6, dtype=np.uint8), 8)
                for _ in range(3)]
        for rid in rids:
            with pytest.raises(InferenceError, match="injected decode fault"):
                cli.result(rid)
        assert srv.error is not None
        assert gen.pages_leaked() == 0


def test_cli_serves_generation_until_max_requests(tmp_path):
    """``python -m znicz_torch charlm --serve --generate``: a generate
    request and a scoring one answered, the run ends at ``max_requests``
    with exit 0; ``--generate`` without ``--serve`` exits 2."""
    import os
    import pathlib
    import subprocess
    import sys

    from znicz_torch.__main__ import main
    from znicz_torch.serving import InferenceClient

    assert main(["charlm", "--generate", "--device", "cpu"]) == 2
    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "znicz_torch", "charlm", "--serve",
         "tcp://127.0.0.1:*", "--device", "cpu", "--generate",
         "root.common.serving.max_requests=2",
         "root.common.serving.generate.page_size=8",
         "root.charlm.loader.n_train=32", "root.charlm.loader.n_valid=16",
         "root.charlm.loader.seq_len=16"],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(repo)})
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving charlm at tcp://127.0.0.1:"), \
            line + proc.stderr.read()
        endpoint = line.split(" at ")[1].split()[0]
        cli = InferenceClient(endpoint, timeout=120)
        try:
            rep = cli.generate(np.arange(1, 6, dtype=np.uint8), 4)
            assert rep["tokens"].shape == (4,) and rep["prompt_len"] == 5
            assert cli.infer(np.ones((1, 5), np.uint8)).shape == \
                (1, 5, VOCAB)
        finally:
            cli.close()
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert '"served": 2' in out.splitlines()[-1]


# -- the reference against the port ----------------------------------------------


def _carried_pair(seq_len=32):
    """The reference's charlm and the port's, the reference's weights
    nudged by a seeded normal and carried across (``params_from_jax``)."""
    from znicz_torch.weights import params_from_jax

    jwf = _ref_charlm_wf(seq_len)
    twf = _charlm_wf(seq_len)
    rng = np.random.default_rng(29)
    tree = {f.name: {k: (np.array(a.map_read())
                         + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
                     for k, a in f.params().items()}
            for f in jwf.forwards}
    for f in jwf.forwards:
        for k, a in f.params().items():
            a.mem = tree[f.name][k].copy()
    params_from_jax(tree, twf)
    return jwf, twf


def _both_runners(**kw):
    from znicz_tpu.serving.model import ModelRunner as JRunner
    from znicz_torch.serving.model import ModelRunner

    jwf, twf = _carried_pair()
    args = dict(page_size=8, num_pages=16, slots=2, prefill_chunk=8, **kw)
    return (JRunner(jwf).enable_generation(**args),
            ModelRunner(twf).enable_generation(**args))


def test_generation_runner_matches_the_reference():
    """One prompt through both packages' runners by hand: the prefill
    chunks' and every decode step's logits to ``CROSS_TOL``, 20 greedy
    tokens equal."""
    jg, tg = _both_runners()
    rng = np.random.default_rng(53)
    prompt = rng.integers(1, VOCAB, size=11).astype(np.uint8)

    def drive(g):
        pages, logits_seen, toks = [], [], []
        t0 = 0
        while t0 < len(prompt):
            n = min(8, len(prompt) - t0)
            while len(pages) < -(-(t0 + n) // 8):
                pages.append(g.alloc_page())
            x = np.zeros((1, 8), np.uint8)
            x[0, :n] = prompt[t0:t0 + n]
            tok, logp, logits, _ = g.prefill(x, [t0], [n], [pages], [0.0],
                                             [0], [0])
            logits_seen.append(np.asarray(logits[0]))
            t0 += n
        toks.append(int(tok[0]))
        t = len(prompt)
        for _ in range(19):
            if t % 8 == 0:
                pages.append(g.alloc_page())
            tok, logp, logits, _ = g.decode([pages], [toks[-1]], [t], [0.0],
                                            [0], [0])
            logits_seen.append(np.asarray(logits[0]))
            toks.append(int(tok[0]))
            t += 1
        return toks, logits_seen

    jt, jl = drive(jg)
    tt, tl = drive(tg)
    assert len(tt) == 20 and tt == jt
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **CROSS_TOL)


@pytest.mark.parametrize("on_device", [True, False],
                         ids=["on_device", "host"])
def test_scheduler_replies_match_the_reference(on_device):
    """One scripted stream (greedy and seeded sampled requests, a shared
    prefix, logits and log-probabilities asked for) through both
    packages' schedulers: the same tokens, the logits and
    log-probabilities to ``CROSS_TOL``."""
    from znicz_tpu.serving.batcher import GenerationScheduler as JSched
    from znicz_tpu.serving.batcher import GenSeq as JSeq
    from znicz_torch.serving.batcher import GenerationScheduler, GenSeq

    jg, tg = _both_runners()
    rng = np.random.default_rng(61)
    shared = rng.integers(1, VOCAB, size=8).astype(np.uint8)
    script = []
    for rid in range(6):
        prompt = np.concatenate([shared, rng.integers(
            1, VOCAB, size=rid + 1).astype(np.uint8)]) if rid % 2 else \
            rng.integers(1, VOCAB, size=3 + rid).astype(np.uint8)
        sampled = rid % 3 == 2
        script.append(dict(prompt=prompt, max_new=5 + rid,
                           temperature=0.8 if sampled else 0.0,
                           top_k=6 if rid == 5 else 0,
                           seed=1000 + rid if sampled else None,
                           return_logits=True, return_logprobs=True,
                           req_id=rid))

    def run(sched_cls, seq_cls, g):
        sched = sched_cls(g, max_new_cap=16, on_device_sampling=on_device)
        for kw in script:
            kw = dict(kw)
            assert sched.submit(seq_cls(kw.pop("prompt"), kw.pop("max_new"),
                                        **kw)) is None
        replies = []
        for _ in range(400):
            if not sched.work_available():
                break
            replies.extend(sched.step()[1])
        return _finals(replies)

    want = run(JSched, JSeq, jg)
    got = run(GenerationScheduler, GenSeq, tg)
    assert set(got) == set(want) == set(range(6))
    for rid in range(6):
        g_, w = got[rid], want[rid]
        assert g_["ok"] and w["ok"]
        np.testing.assert_array_equal(g_["tokens"], w["tokens"])
        np.testing.assert_allclose(g_["logits"], w["logits"], **CROSS_TOL)
        np.testing.assert_allclose(g_["logprobs"], w["logprobs"],
                                   **CROSS_TOL)


# -- the soak ----------------------------------------------------------------------


@pytest.mark.slow
def test_generate_chaos_soak():
    """Generations through a ChaosProxy (drops, corruption, duplicates and
    delays both ways): every request answers, resends of in-flight
    generations are absorbed, greedy streams stay the same, nothing enters
    the family after the first pass, and the pool ends at exactly the
    shared-prefix residue."""
    from znicz_torch.parallel.chaos import ChaosProxy, FaultSchedule
    from znicz_torch.serving import InferenceClient

    with _gen_service() as (srv, ref_cli):
        schedule = FaultSchedule(seed=77, drop=0.08, corrupt=0.05,
                                 duplicate=0.08, delay=0.05,
                                 delay_s=(0.005, 0.03))
        proxy = ChaosProxy("tcp://127.0.0.1:*", srv.endpoint,
                           schedule).start()
        cli = InferenceClient(proxy.front_endpoint, timeout=120,
                              resend_after_s=0.3, breaker_failures=0)
        rng = np.random.default_rng(29)
        try:
            shared = rng.integers(1, VOCAB, size=8).astype(np.uint8)
            prompts = []
            for i in range(12):
                tail = rng.integers(1, VOCAB, size=int(rng.integers(2, 8))
                                    ).astype(np.uint8)
                prompts.append(np.concatenate([shared, tail])
                               if i % 2 else tail)
            want = [ref_cli.generate(p, 8)["tokens"] for p in prompts]
            srv.gen_sched.gen.warmup()
            warm = srv.runner.compiles
            rids = [cli.submit_generate(p, 8) for p in prompts]
            got = {}
            deadline = time.time() + 300
            while len(got) < len(rids) and time.time() < deadline:
                for rep in cli.collect(0.05):
                    if rep.get("ok") and not rep.get("partial"):
                        got[rep["req_id"]] = rep["tokens"]
            assert len(got) == len(rids), (len(got), len(rids))
            for rid, w in zip(rids, want):
                np.testing.assert_array_equal(got[rid], w)
            assert srv.runner.compiles == warm
            g = srv.gen_sched.gen
            st = g.stats()
            assert st["pages_leaked"] == 0
            assert st["pages_active"] == st["prefix_pages"]
            held = [p for p in range(g.num_pages) if g.page_ref[p] > 0]
            assert all(g.page_ref[p] == 1 for p in held)
        finally:
            cli.close()
            proxy.stop()
