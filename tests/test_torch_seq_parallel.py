"""Sequence parallelism (``seq_parallel``) on gloo ranks on the CPU: the
port's ring attention, ``MultiHeadAttention``'s private ("sp",) mesh and
its binding to a trainer's mesh, against the reference.  Spawned
processes, one a rank, joined over a ``FileStore`` in ``tmp_path`` (never
a fixed port), each writing its results to a file; one spawn of 2 ranks
and one of 4, each running several scenarios, as
``tests/test_torch_multiprocess.py`` spawns them.

The reference's oracles are its 1-D ring under ``shard_map`` on an
("sp",) mesh of as many virtual devices as the port has ranks, and its
dense ``attention``; never its ring bound to a 2-D mesh, which fails
inside its own loop on this tree (its carries are cast as varying over
the sequence axis only).  Tolerances: the reference's, rtol 2e-4 / atol
1e-5 for outputs and rtol 2e-4 / atol 1e-6 for gradients.

Run as a script, this file is the rank worker:
``python test_torch_seq_parallel.py RANK WORLD STORE OUTDIR SCENARIOS``.
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FWD_TOL = {"rtol": 2e-4, "atol": 1e-5}
GRAD_TOL = {"rtol": 2e-4, "atol": 1e-6}
#: the cross-layout band of ``tests/test_shard_training.py:165-170``
LOSS_RTOL = 1e-3
W_TOL = {"rtol": 2e-3, "atol": 2e-5}
#: a reduced charlm: 4 train steps an epoch of 16 rows of 16 tokens
CHARLM = {"loader__n_train": 64, "loader__n_valid": 16, "loader__n_test": 0,
          "loader__seq_len": 16, "loader__minibatch_size": 16,
          "model__vocab": 32, "model__embed": 48, "model__heads": 2,
          "model__ffn": 96, "learning_rate": 0.5,
          "decision__max_epochs": 2}
#: the MultiHeadAttention cases: x (batch, T, embed) with 2 heads
MHA_EMBED, MHA_BATCH = 8, 4
#: the longest the parent waits for a group of ranks
JOIN_S = 120


def ring_inputs(world: int, causal: bool):
    """q, k, v and the output's cotangent, (2, 8·world, 2, 4) float32
    from a numpy generator seeded by (world, causal)."""
    rng = np.random.default_rng(33 + 2 * world + int(causal))
    return tuple(rng.normal(size=(2, 8 * world, 2, 4)).astype(np.float32)
                 for _ in range(4))


def mha_input(t: int, seed: int = 47):
    rng = np.random.default_rng(seed + t)
    return rng.normal(size=(MHA_BATCH, t, MHA_EMBED)).astype(np.float32)


# -- the scenarios, run in each rank -------------------------------------------


def _grads(fn, inputs, cot):
    """(fn(*inputs), the gradients of <fn, cot> by each input) as numpy."""
    import torch

    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(np.ascontiguousarray(cot)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def run_ring(world, rank):
    """The port's ring on this rank's blocks, causal and not: the output
    block and the q/k/v blocks' gradients, and the P2P calls made."""
    import torch.distributed as dist

    from znicz_torch.ops.attention import ring_attention
    from znicz_torch.parallel import mesh as mesh_mod

    group = dist.group.WORLD
    out = {}
    for causal in (False, True):
        q, k, v, cot = ring_inputs(world, causal)
        t = q.shape[1] // world
        blk = slice(rank * t, (rank + 1) * t)
        calls = mesh_mod.STATS["calls"]
        o, g = _grads(lambda q, k, v: ring_attention(q, k, v, group,
                                                     causal=causal),
                      (q[:, blk], k[:, blk], v[:, blk]), cot[:, blk])
        out[causal] = {"out": o, "grads": g,
                       "p2p": mesh_mod.STATS["calls"] - calls}
    return out


def _mha(name, t, causal=True):
    from znicz_torch.attention import MultiHeadAttention
    from znicz_torch.core import prng

    prng.reset(1013)
    mod = MultiHeadAttention(name=name, heads=2, causal=causal,
                             residual=True)
    mod.build((MHA_BATCH, t, MHA_EMBED), "cpu")
    return mod


def _mha_run(mod, x, cot):
    """The module's output on ``x`` and the gradients of <y, cot> by x and
    by its four projections."""
    import torch

    params = [mod.wq, mod.wk, mod.wv, mod.wo]
    for p in params:
        p.requires_grad_(True)
        p.grad = None
    xt = torch.tensor(x, requires_grad=True)
    y = mod(xt)
    y.backward(torch.from_numpy(cot))
    out = {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
           "dw": {k: p.grad.numpy().copy()
                  for k, p in zip(("wq", "wk", "wv", "wo"), params)},
           "w": {k: p.detach().numpy().copy()
                 for k, p in zip(("wq", "wk", "wv", "wo"), params)}}
    for p in params:
        p.requires_grad_(False)
    return out


def run_mha_sp(world, rank, sp):
    """``seq_parallel = sp`` on a world of ``world``: the module takes its
    private mesh at its first forward; its output and gradients beside
    the dense module's on the same weights; a short length that ``sp``
    does not divide (the dense core, bit for bit); a built length it
    does not divide refused."""
    from test_torch_multiprocess import port_config

    t = 8 * sp
    x, cot = mha_input(t), mha_input(t, seed=91)
    dense = _mha("mha", t)
    with port_config(seq_parallel=sp):
        ring = _mha("mha", t)
        out = {"built_mesh": ring._sp_mesh,
               "ring": _mha_run(ring, x, cot),
               "dense": _mha_run(dense, x, cot)}
        mesh = ring._sp_mesh
        out["mesh"] = (tuple(mesh.mesh_dim_names),
                       tuple(int(s) for s in mesh.shape))
        short = mha_input(2 * sp + 1)
        out["short"] = (_mha_run(ring, short, short)["y"],
                        _mha_run(dense, short, short)["y"])
        try:
            _mha("mha_bad", 8 * sp + 1)
            out["refused"] = None
        except ValueError as exc:
            out["refused"] = str(exc)
    return out


def _ring_ranks(mod):
    """The global ranks of the group the module's core rings over."""
    import torch.distributed as dist

    from znicz_torch.parallel import mesh as mesh_mod

    group = mesh_mod.axis_group(mod._sp_mesh, mod._seq_axis)
    return dist.get_process_group_ranks(group)


def run_bind(world, rank):
    """``bind_sequence_mesh`` on four ranks: refused for None and (4, 1);
    bound on (2, 2), each data row forwarding its rows of the batch."""
    from znicz_torch.parallel import mesh as mesh_mod

    t = 16
    x, cot = mha_input(t), mha_input(t, seed=91)
    mod = _mha("mha_bind", t)
    out = {"none": mod.bind_sequence_mesh(None),
           "4x1": mod.bind_sequence_mesh(
               mesh_mod.make_mesh((4, 1), ("data", "model")))}
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    out["2x2"] = mod.bind_sequence_mesh(mesh)
    out["ring_ranks"] = _ring_ranks(mod)
    d = mesh_mod.axis_index(mesh, "data")
    rows = slice(2 * d, 2 * d + 2)
    out["rows"] = (rows.start, rows.stop)
    out["run"] = _mha_run(mod, x[rows], cot[rows])
    return out


def run_charlm(world, rank, snapdir):
    """The reduced charlm on ``FusedTrainer`` on (1, 2) with
    ``seq_parallel`` 2: the attention bound to the trainer's mesh, the
    TRAIN losses and the whole parameters."""
    from test_torch_multiprocess import port_config

    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.parallel import mesh as mesh_mod
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.charlm import CharLMWorkflow
    from znicz_torch.weights import params_to_numpy

    root.common.dirs.snapshots = snapdir
    with port_config("charlm", CHARLM, seq_parallel=2):
        prng.reset(1013)
        wf = CharLMWorkflow(device="cpu")
        mesh = mesh_mod.make_mesh((1, 2), ("data", "model"))
        trainer = FusedTrainer(wf, mesh=mesh)
        mha = next(f for f in trainer.forwards if f.name == "mha")
        calls = mesh_mod.STATS["calls"]
        trainer.run()
        return {"bound": mha._sp_mesh is mesh, "ring_ranks": _ring_ranks(mha),
                "losses": [float(x) for x in wf.decision.train_losses],
                "params": params_to_numpy(wf),
                "collectives": mesh_mod.STATS["calls"] - calls,
                "uncaptured": trainer.uncaptured_reason}


def run_refusals(world, rank):
    """``seq_parallel`` 2 with an attention layer: ``FusedTrainer`` on a
    mesh with no ``model`` axis to ring over ((world, 1): its ranks hold
    different rows) raises ``ValueError``; unmeshed, it runs uncaptured
    (the ring's hops are host-staged); in a world of 4 the knob's own
    ring of 2 ranks is refused at the first forward."""
    from test_torch_multiprocess import port_config

    from znicz_torch.core import prng
    from znicz_torch.parallel import mesh as mesh_mod
    from znicz_torch.parallel.fused import FusedTrainer
    from znicz_torch.samples.charlm import CharLMWorkflow

    out = {}
    with port_config("charlm", CHARLM, seq_parallel=2):
        prng.reset(1013)
        wf = CharLMWorkflow(device="cpu")
        mesh = mesh_mod.make_mesh((world, 1), ("data", "model"))
        try:
            FusedTrainer(wf, mesh=mesh)
            out["trainer"] = None
        except ValueError as exc:
            out["trainer"] = str(exc)
        mha = next(f for f in wf.forwards if f.name == "mha")
        out["bound"] = mha._sp_mesh is not None
        out["unmeshed"] = FusedTrainer(wf).uncaptured_reason
        if world != 2:
            try:
                _mha_run(_mha("mha_world", 16), mha_input(16),
                         mha_input(16, seed=91))
                out["forward"] = None
            except RuntimeError as exc:
                out["forward"] = str(exc)
    return out


SCENARIOS = {"ring": run_ring, "mha_sp": run_mha_sp, "bind": run_bind,
             "charlm": run_charlm, "refusals": run_refusals}


def worker(rank: int, world: int, store: str, outdir: str,
           scenarios: list) -> None:
    import torch

    from znicz_torch.parallel.mesh import distributed_init

    torch.set_num_threads(1)
    distributed_init(f"file://{store}", world, rank, backend="gloo",
                     device="cpu")
    out = {}
    for label, name, kw in scenarios:
        if name == "charlm":
            kw = dict(kw, snapdir=os.path.join(outdir, f"snap_{rank}"))
        out[label] = SCENARIOS[name](world, rank, **kw)
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules}
                             & {"jax", "jaxlib", "znicz_tpu"})
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# -- the parent ----------------------------------------------------------------


def spawn(tmp_path, world: int, scenarios: list) -> list:
    """Run ``scenarios`` ([(label, scenario, kwargs)]) on ``world`` gloo
    ranks; each rank's {label: record}."""
    outdir = tmp_path / f"ranks{world}"
    outdir.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(outdir / "store"), str(outdir), json.dumps(scenarios)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(world)]
    deadline = time.monotonic() + JOIN_S
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, (rank, err[-4000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out = []
    for rank in range(world):
        with open(outdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("sp2"), 2, [
        ("ring", "ring", {}), ("mha_sp", "mha_sp", {"sp": 2}),
        ("charlm", "charlm", {}), ("refusals", "refusals", {})])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("sp4"), 4, [
        ("ring", "ring", {}), ("mha_sp", "mha_sp", {"sp": 4}),
        ("bind", "bind", {}), ("refusals", "refusals", {})])


@pytest.mark.parametrize("world", [2, 4])
def test_the_ranks_never_import_jax(world, request):
    """Every scenario ran in a rank where neither jax nor the reference
    was imported."""
    assert [r["imported"] for r in _ranks(request, world)] == [[]] * world


def _ranks(request, world):
    return request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])


def _reference_ring(world, causal):
    """The reference's ring under ``shard_map`` on an ("sp",) mesh of
    ``world`` virtual devices, and its dense ``attention``: each (output,
    [dq, dk, dv]) for the cotangent of :func:`ring_inputs`."""
    import jax
    from jax.sharding import PartitionSpec as P

    from znicz_tpu.ops.attention import attention, ring_attention
    from znicz_tpu.parallel.mesh import make_mesh, shard_map

    q, k, v, cot = ring_inputs(world, causal)
    spec = P(None, "sp")
    ring = shard_map(
        lambda q, k, v: ring_attention(q, k, v, "sp", causal=causal),
        mesh=make_mesh((world,), ("sp",)), in_specs=(spec, spec, spec),
        out_specs=spec)
    out = {}
    for label, fn in (("ring", ring),
                      ("dense", lambda q, k, v: attention(q, k, v,
                                                          causal=causal))):
        def value_and_vjp(q, k, v, cot, fn=fn):
            y, vjp = jax.vjp(fn, q, k, v)
            return y, vjp(cot)

        y, grads = jax.jit(value_and_vjp)(q, k, v, cot)
        out[label] = (np.asarray(y), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_matches_the_reference(world, causal, request):
    """Each rank's output block and q/k/v gradient blocks against the
    reference's 1-D ring and its dense core over the whole sequence; the
    ring made n - 1 shifts forward and as many backward."""
    ranks = _ranks(request, world)
    refs = _reference_ring(world, causal)
    t = 8
    for rank, rec in enumerate(ranks):
        got = rec["ring"][causal]
        blk = slice(rank * t, (rank + 1) * t)
        for label, (y, grads) in refs.items():
            np.testing.assert_allclose(got["out"], y[:, blk],
                                       err_msg=f"{label} rank {rank}",
                                       **FWD_TOL)
            for name, g, want in zip("qkv", got["grads"], grads):
                np.testing.assert_allclose(
                    g, want[:, blk], err_msg=f"{label} d{name} rank {rank}",
                    **GRAD_TOL)
        assert got["p2p"] == 2 * (world - 1)


def _reference_mha(x, w, cot):
    """The reference's MultiHeadAttention (causal, residual, dense core)
    on the parameters ``w``: its output and the vjp by x and each
    projection."""
    import jax

    from znicz_tpu.attention import MultiHeadAttention as JMHA
    from znicz_tpu.memory import Array

    unit = JMHA(name="ref_mha", heads=2, causal=True, residual=True)
    unit.input = Array(x)
    unit.initialize(device=None)
    y, vjp = jax.vjp(unit.apply, dict(w), x)
    dw, dx = vjp(cot)
    return np.asarray(y), np.asarray(dx), {k: np.asarray(g)
                                           for k, g in dw.items()}


def _check_mha(got, x, cot, tag):
    y, dx, dw = _reference_mha(x, got["w"], cot)
    np.testing.assert_allclose(got["y"], y, err_msg=tag, **FWD_TOL)
    np.testing.assert_allclose(got["dx"], dx, err_msg=f"{tag} dx",
                               **GRAD_TOL)
    for k, g in dw.items():
        np.testing.assert_allclose(got["dw"][k], g, err_msg=f"{tag} d{k}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("world,label,sp", [(2, "mha_sp", 2),
                                            (4, "mha_sp", 4)])
def test_mha_on_its_private_mesh_matches_the_dense_module(world, label, sp,
                                                          request):
    """``seq_parallel = sp`` takes the module's ("sp",) mesh of the whole
    world at its first forward (none at build); on every rank its output
    and gradients equal the dense module's on the same weights, and both
    lie within the reference's tolerances of the reference's dense
    MultiHeadAttention."""
    ranks = _ranks(request, world)
    t = 8 * sp
    x, cot = mha_input(t), mha_input(t, seed=91)
    for rank, rec in enumerate(ranks):
        got = rec[label]
        assert got["built_mesh"] is None
        assert got["mesh"] == (("sp",), (sp,))
        ring, dense = got["ring"], got["dense"]
        for k in ring["w"]:
            np.testing.assert_array_equal(ring["w"][k], dense["w"][k])
        np.testing.assert_allclose(ring["y"], dense["y"], **FWD_TOL)
        np.testing.assert_allclose(ring["dx"], dense["dx"], **GRAD_TOL)
        _check_mha(ring, x, cot, f"ring rank {rank}")
        _check_mha(dense, x, cot, f"dense rank {rank}")
    for rec in ranks[1:]:
        np.testing.assert_array_equal(rec[label]["ring"]["y"],
                                      ranks[0][label]["ring"]["y"])
        np.testing.assert_array_equal(rec[label]["ring"]["dx"],
                                      ranks[0][label]["ring"]["dx"])


@pytest.mark.parametrize("world,label", [(2, "mha_sp"), (4, "mha_sp")])
def test_mha_short_length_takes_the_dense_core(world, label, request):
    """A length the ring cannot split (a short serving bucket) takes the
    dense core: the same bits as the dense module's."""
    for rec in _ranks(request, world):
        ring, dense = rec[label]["short"]
        np.testing.assert_array_equal(ring, dense)


@pytest.mark.parametrize("world,label", [(2, "mha_sp"), (4, "mha_sp")])
def test_mha_refuses_a_length_the_ring_cannot_split(world, label, request):
    """A built length the knob does not divide raises ``ValueError``
    naming ``seq_parallel``, as the reference's initialize does."""
    for rec in _ranks(request, world):
        assert "seq_parallel" in rec[label]["refused"]
        assert "cannot split sequence length" in rec[label]["refused"]


def test_mha_refuses_the_knob_without_a_world():
    """In one process (no world of ranks) the knob raises readably at the
    first forward, naming ``seq_parallel`` and ``torchrun``; off, the
    module builds and runs dense."""
    from test_torch_multiprocess import port_config

    with port_config(seq_parallel=2):
        mod = _mha("mha_alone", 16)
        with pytest.raises(RuntimeError, match="seq_parallel=2") as exc:
            _mha_run(mod, mha_input(16), mha_input(16, seed=91))
        assert "torchrun" in str(exc.value)
        with pytest.raises(ValueError, match="seq_parallel"):
            _mha("mha_alone", 15)
    assert _mha("mha_alone", 16)._sp_mesh is None


def test_bind_sequence_mesh_refusals_and_parity(four_ranks):
    """``bind_sequence_mesh`` refuses None and a (4, 1) mesh (no sequence
    axis to ring over) and binds (2, 2), ringing over its data row's
    ``model`` group;
    each data row's output and gradients match the reference's dense
    MultiHeadAttention on its rows (not its 2-D bound ring, which fails
    on this tree)."""
    x, cot = mha_input(16), mha_input(16, seed=91)
    for rank, rec in enumerate(four_ranks):
        got = rec["bind"]
        assert got["none"] is False and got["4x1"] is False
        assert got["2x2"] is True
        assert got["ring_ranks"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        lo, hi = got["rows"]
        assert (lo, hi) == ((0, 2) if rank < 2 else (2, 4))
        _check_mha(got["run"], x[lo:hi], cot[lo:hi], f"rank {rank}")


def test_charlm_on_a_sequence_mesh_matches_the_reference(two_ranks,
                                                         tmp_path):
    """The reduced charlm on ``FusedTrainer`` on (1, 2) with
    ``seq_parallel`` 2: its attention bound to the trainer's mesh, the run
    uncaptured, the two ranks' trees bit-equal, and its TRAIN losses and
    parameters within the cross-layout band of the reference's unmeshed
    ``FusedTrainer`` from the same seed."""
    from test_torch_charlm import _ref_params, _reference
    from test_torch_engine import _record_train_losses
    from znicz_tpu.core.config import root as jroot
    from znicz_tpu.engine import train as jtrain

    cfg = {k: v for k, v in CHARLM.items() if k != "decision__max_epochs"}
    jwf = _reference(tmp_path, cfg, max_epochs=CHARLM["decision__max_epochs"])
    losses = _record_train_losses(jwf.decision)
    jroot.common.engine.fused = True
    try:
        jtrain(jwf)
    finally:
        jroot.common.engine.fused = False
    want = _ref_params(jwf)
    recs = [r["charlm"] for r in two_ranks]
    for rec in recs:
        assert rec["bound"] and rec["ring_ranks"] == [0, 1]
        assert rec["uncaptured"] and rec["collectives"] > 0
        for name, leaves in recs[0]["params"].items():
            for k, a in leaves.items():
                np.testing.assert_array_equal(rec["params"][name][k], a)
    got = recs[0]
    assert len(got["losses"]) == len(losses) == 8
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    for name, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got["params"][name][k], v,
                                       err_msg=f"{name}.{k}", **W_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_refuses_a_mesh_with_no_sequence_axis(world, request):
    """``FusedTrainer`` on (world, 1) with ``seq_parallel`` 2 and an
    attention layer raises ``ValueError`` naming the missing ``model``
    axis, binding nothing: a ring over its data ranks would join blocks
    of different rows.  Unmeshed, the trainer names the ring as the
    reason it captures nothing.  In a world of 4 the layer's own ring of
    2 is refused at its first forward, naming ``seq_parallel``."""
    for rec in _ranks(request, world):
        got = rec["refusals"]
        assert got["trainer"] is not None
        assert "seq_parallel=2" in got["trainer"]
        assert "model axis" in got["trainer"]
        assert got["bound"] is False
        assert "ring attention" in got["unmeshed"]
        if world == 4:
            assert "seq_parallel=2" in got["forward"]
            assert "world has 4" in got["forward"]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           [tuple(s) for s in json.loads(sys.argv[5])])
