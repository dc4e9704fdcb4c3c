"""The serving mesh on ``torch.distributed`` on the CPU (after
``tests/test_shard_serving.py``):

  - ``BucketLadder`` snaps its rungs to multiples of the ``data`` axis
    and refuses what cannot split, as the reference's does, for
    (max_batch, dp) in (128, 1), (128, 2), (96, 4), (7, 2) and explicit
    rungs; ``require_batch_divisible`` refuses as the reference's;
  - two gloo ranks, spawned and joined over a ``FileStore`` in
    ``tmp_path`` (no fixed port), serve the 67x67 AlexNet probe through
    ``InferenceServer`` on rank 0 (``root.common.serving.mesh``) while
    rank 1 follows, on meshes (2, 1) and (1, 2): every reply within the
    cross-layout band (``BAND``, ROADMAP C.5) of one process's; a swap,
    a rollback and two failed swaps (a missing file; a load that fails on
    rank 1 alone) keep both ranks on one generation, and the ranks
    dispatch alike;
  - the same two ranks on (2, 1) serve the reduced charlm on the 2-D
    (rows x seq) ladder: the rows snapped to dp, each (rows, seq) bucket
    scattered by rows, every variable-length reply within ``BAND`` of
    one process's forward of its padded bucket.

Run as a script, this file is the rank worker:
``python test_torch_serving_mesh.py RANK WORLD STORE OUTDIR``.
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the cross-layout band of ``tests/test_shard_training.py:165-170``
BAND = {"rtol": 2e-3, "atol": 2e-5}
ALEXNET = (67, 67, 3)
SEED = 1013
SHAPES = ((2, 1), (1, 2))
SIZES = (1, 3, 2, 4, 1, 5, 2)
#: the limit a rank pair is given to finish (a hang guard)
JOIN_S = 300


# -- the ladder and the refusals ----------------------------------------------


@pytest.mark.parametrize("max_batch,dp", [(128, 1), (128, 2), (96, 4),
                                          (7, 2)])
def test_ladder_snaps_and_refuses_as_the_reference(max_batch, dp):
    from znicz_torch.serving import BucketLadder
    from znicz_tpu.serving import BucketLadder as JLadder

    def build(cls, *args, **kw):
        """The rungs, or the refusal up to its advice (the port's names
        a rank where the reference's names a device)."""
        try:
            return cls(*args, **kw).rungs
        except ValueError as exc:
            return ("refused", str(exc).split(";")[0])

    got = build(BucketLadder, max_batch, dp=dp)
    assert got == build(JLadder, max_batch, dp=dp)
    if max_batch % dp:
        assert got[0] == "refused" and "does not divide" in got[1]
    else:
        assert all(r % dp == 0 for r in got) and got[-1] == max_batch
    for rungs in ([2, max_batch], [1, 3, max_batch], [dp, 2 * dp, max_batch]):
        got = build(BucketLadder, max_batch, rungs, dp=dp)
        assert got == build(JLadder, max_batch, rungs, dp=dp), rungs


def test_require_batch_divisible_refuses_as_the_reference():
    from znicz_torch.parallel.mesh import require_batch_divisible
    from znicz_tpu.parallel.mesh import require_batch_divisible as jrequire

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: (4, 2)[i])
    jmesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    assert require_batch_divisible(8, mesh) == jrequire(8, jmesh) == 4
    with pytest.raises(ValueError) as got:
        require_batch_divisible(6, mesh)
    with pytest.raises(ValueError) as want:
        jrequire(6, jmesh)
    assert str(got.value) == str(want.value)


# -- the ranks ----------------------------------------------------------------


def _alexnet():
    from znicz_torch.core import prng
    from znicz_torch.samples.alexnet import AlexNetWorkflow

    prng.reset(SEED)
    return AlexNetWorkflow(sample_shape=ALEXNET, n_classes=10, device="cpu")


def _serve(srv, requests):
    """Every request submitted at once; the replies in order."""
    from znicz_torch.serving import Request

    futs = [Future() for _ in requests]
    for i, x in enumerate(requests):
        srv.submit(Request(x, x.shape[0], reply_to=futs[i], req_id=i))
    return [f.result(120) for f in futs]


def _lead(requests, spec):
    """Rank 0: the server, its traffic, the swaps and the rollback."""
    from znicz_torch.serving import InferenceServer

    srv = InferenceServer(_alexnet(), max_batch=8, max_delay_ms=1.0,
                          queue_bound=256).start()
    runner = srv.runner
    rec = {"rungs": list(srv.batcher.ladder.rungs),
           "mesh": runner.mesh_shape, "capture": runner.capture,
           "compiles": runner.compiles, "steps": []}
    try:
        rec["steps"].append(("serve", _serve(srv, requests)))
        runner.swap(spec["gen2"], srv.batcher.ladder)
        rec["steps"].append(("serve", _serve(srv, requests)))
        rec["rollback"] = runner.rollback()
        rec["steps"].append(("serve", _serve(srv, requests)))
        for path in (spec["missing"], spec["rank1_fails"]):
            try:
                runner.swap(path, srv.batcher.ladder)
            except RuntimeError as exc:
                rec.setdefault("failed_swaps", []).append(str(exc))
        rec["steps"].append(("serve", _serve(srv, requests[:2])))
    finally:
        srv.stop()
    rec.update(generation=runner.generation, dispatches=runner.dispatches,
               swaps=runner.swaps, swap_failures=runner.swap_failures,
               rollbacks=runner.rollbacks, path=runner.snapshot_path)
    return rec


def _follow(spec):
    """Rank 1: the follower, recording each generation step it takes."""
    from znicz_torch import snapshotter
    from znicz_torch.serving import ModelRunner

    runner = ModelRunner(_alexnet())
    history = []
    flip, roll_back, load = runner._flip, runner._roll_back, \
        snapshotter.Snapshotter.load

    def flip_(gen):
        history.append(("flip", gen))
        return flip(gen)

    def roll_back_():
        out = roll_back()
        history.append(("rollback", out[0]))
        return out

    def load_(path):
        if path == spec["rank1_fails"]:
            raise OSError("this rank cannot read the snapshot")
        return load(path)

    runner._flip, runner._roll_back = flip_, roll_back_
    snapshotter.Snapshotter.load = staticmethod(load_)
    try:
        runner.follow()
    finally:
        snapshotter.Snapshotter.load = staticmethod(load)
    return {"history": history, "generation": runner.generation,
            "dispatches": runner.dispatches, "path": runner.snapshot_path,
            "mesh": runner.mesh_shape, "capture": runner.capture}


#: the reduced charlm of the 2-D case, and its requests' (rows, length)
CHARLM = {"n_train": 32, "n_valid": 16, "seq_len": 16, "minibatch_size": 16}
SEQ_SIZES = ((1, 3), (2, 16), (3, 5), (1, 9), (4, 1), (2, 7))


def _charlm():
    from znicz_torch.core import prng
    from znicz_torch.core.config import root
    from znicz_torch.samples.charlm import CharLMWorkflow

    root.charlm.loader.update(CHARLM)
    prng.reset(SEED)
    return CharLMWorkflow(device="cpu")


def _charlm_ranks(rank, requests):
    """Rank 0 serves the requests on the (2, 1) mesh; rank 1 follows."""
    from znicz_torch.core.config import root
    from znicz_torch.serving import InferenceServer, ModelRunner, Request

    root.common.serving.mesh.data = 2
    root.common.serving.mesh.model = 1
    if rank:
        ModelRunner(_charlm()).follow()
        return {}
    srv = InferenceServer(_charlm(), max_batch=4, max_delay_ms=1.0).start()
    try:
        futs = [Future() for _ in requests]
        for i, x in enumerate(requests):
            srv.submit(Request(x, x.shape[0], reply_to=futs[i], req_id=i,
                               seq_len=x.shape[1]))
        replies = [f.result(120) for f in futs]
    finally:
        srv.stop()
    return {"buckets": srv.batcher.ladder.buckets(), "replies": replies,
            "compiles": srv.runner.compiles}


def worker(rank: int, world: int, store: str, outdir: str) -> None:
    import torch

    from znicz_torch.core.config import root
    from znicz_torch.parallel.mesh import distributed_init

    torch.set_num_threads(1)
    distributed_init(f"file://{store}", world, rank, backend="gloo",
                     device="cpu")
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(spec["requests"])
    requests = [data[f"r{i}"] for i in range(len(data.files))]
    if spec.get("sample") == "charlm":
        out = _charlm_ranks(rank, requests)
    else:
        out = {}
        for dp, mp in SHAPES:
            root.common.serving.mesh.data = dp
            root.common.serving.mesh.model = mp
            out[dp, mp] = (_lead(requests, spec) if rank == 0
                           else _follow(spec))
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # the group's threads end here, not in the interpreter's teardown
    torch.distributed.destroy_process_group()


# -- the parent ---------------------------------------------------------------


def _spawn(outdir: pathlib.Path, world: int = 2) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(outdir / "store"), str(outdir)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
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


def test_two_ranks_serve_alexnet_as_one_process(tmp_path):
    from znicz_torch.serving import BucketLadder, ModelRunner
    from znicz_torch.snapshotter import write_host_pickle

    rng = np.random.default_rng(12)
    requests = [rng.normal(size=(n,) + ALEXNET).astype(np.float32)
                for n in SIZES]
    np.savez(tmp_path / "requests.npz",
             **{f"r{i}": x for i, x in enumerate(requests)})
    one = ModelRunner(_alexnet())
    refs = {1: [one.infer(x) for x in requests]}
    tree = {m: {k: (1.25 * t.numpy() + 0.01).astype(np.float32)
                for k, t in leaves.items()}
            for m, leaves in one._active.tree.items()}
    gen2 = str(tmp_path / "gen2.pickle.gz")
    write_host_pickle(gen2, {"units": tree, "velocities": {}, "epoch": 2})
    two = ModelRunner(_alexnet(), snapshot=gen2)
    refs[2] = [two.infer(x) for x in requests]
    assert np.std(np.concatenate(refs[1])) > 0
    assert min(float(np.abs(a - b).max())
               for a, b in zip(refs[1], refs[2])) > 1e-3
    spec = {"requests": str(tmp_path / "requests.npz"), "gen2": gen2,
            "missing": str(tmp_path / "missing.pickle.gz"),
            "rank1_fails": str(tmp_path / "gen2_copy.pickle.gz")}
    with open(spec["rank1_fails"], "wb") as f, open(gen2, "rb") as g:
        f.write(g.read())
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)

    lead, follow = _spawn(tmp_path)
    for dp, mp in SHAPES:
        rec, frec = lead[dp, mp], follow[dp, mp]
        assert rec["mesh"] == frec["mesh"] == {"data": dp, "model": mp}
        assert rec["capture"] is False and frec["capture"] is False
        assert rec["rungs"] == BucketLadder(8, dp=dp).rungs
        assert all(r % dp == 0 for r in rec["rungs"])
        assert rec["compiles"] == len(rec["rungs"])
        for (kind, replies), gen in zip(rec["steps"], (1, 2, 1, 1)):
            assert kind == "serve"
            for rep, want in zip(replies, refs[gen]):
                assert rep["ok"] and rep["gen"] == gen, rep
                assert np.isfinite(rep["y"]).all()
                np.testing.assert_allclose(rep["y"], want, **BAND)
        # one generation on both ranks, every step of the way
        assert rec["rollback"] == 1
        assert frec["history"] == [("flip", 2), ("rollback", 1)]
        assert rec["generation"] == frec["generation"] == 1
        assert rec["path"] == frec["path"] == ""
        assert (rec["swaps"], rec["swap_failures"], rec["rollbacks"]) == \
            (1, 2, 1)
        assert len(rec["failed_swaps"]) == 2
        assert "rank(s) [1]" in rec["failed_swaps"][1]
        assert rec["dispatches"] == frec["dispatches"] > 0


def test_two_ranks_serve_charlm_on_the_2d_ladder(tmp_path):
    from test_torch_layers import sample_config
    from znicz_torch.serving import BucketLadder, ModelRunner

    rng = np.random.default_rng(14)
    requests = [rng.integers(1, 32, size=(n, L)).astype(np.uint8)
                for n, L in SEQ_SIZES]
    np.savez(tmp_path / "requests.npz",
             **{f"r{i}": x for i, x in enumerate(requests)})
    with open(tmp_path / "spec.json", "w") as f:
        json.dump({"requests": str(tmp_path / "requests.npz"),
                   "sample": "charlm"}, f)
    with sample_config("charlm", **{f"loader__{k}": v
                                    for k, v in CHARLM.items()}):
        one = ModelRunner(_charlm())
    ladder = BucketLadder(4, dp=2, max_len=16)
    lead, _ = _spawn(tmp_path)
    assert lead["buckets"] == ladder.buckets()
    assert lead["buckets"][0] == (2, 1)
    assert lead["compiles"] == len(ladder.buckets())
    for x, rep in zip(requests, lead["replies"]):
        n, L = x.shape
        xb = np.zeros((ladder.bucket_for(n), ladder.seq_bucket_for(L)),
                      np.uint8)
        xb[:n, :L] = x
        assert rep["ok"] and rep["y"].shape == (n, L, 32), rep
        np.testing.assert_allclose(rep["y"], one.infer(xb)[:n, :L], **BAND)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
