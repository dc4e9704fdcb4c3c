"""The meshed slave (``client.FusedClient`` under ``train_shard``): one
slave made of two gloo ranks on the CPU, spawned as
``tests/test_torch_multiprocess.py`` spawns its ranks (one process a
rank over a ``FileStore`` in ``tmp_path``, never a fixed port), against a
master in the test's process; the counterpart of the reference's meshed
slave in ``tests/test_shard_training.py``:

  - on (2, 1) and (1, 2) the handshake carries the mesh's shape (the
    master's ``slave_meshes`` records it) and the digest of a
    single-device slave; a column-sharded leaf is its rank's rows; rank 0
    talks to the master while rank 1 steps on the same jobs; the master's
    tree lies within the cross-layout band (``test_torch_multiprocess.
    W_TOL``) of a single-device slave's after the same jobs, and of the
    reference's master after its own meshed slave on the same layout;
  - a meshed leaf behind a relay is credited through the manifest
    (``slow``, as the reference's soak);
  - ``python -m znicz_torch ... --slave EP --mesh-data 2`` without
    ``torchrun``'s environment exits 2 naming it, and under ``torchrun``
    two ranks train for a master.

Run as a script, this file is the rank worker:
``python test_torch_meshed_slave.py RANK WORLD STORE OUTDIR SPEC``.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_multiprocess import (JOIN_S, MNIST, REPO, W_TOL,
                                     _mnist_workflow, port_config)

#: the reduced MNIST of the mesh tests (hidden 1024 splits over model),
#: two epochs: an eval and two train jobs each
CFG = MNIST
#: the longest the test waits for the master
BUDGET = 120.0
ANY = "tcp://127.0.0.1:*"


def worker(rank: int, world: int, store: str, outdir: str,
           spec: dict) -> None:
    """One rank of the meshed slave: join the group, build the workflow
    and the ``FusedClient`` on ``spec["shape"]``, work for
    ``spec["endpoint"]``; writes what it saw to ``rank<N>.pkl``."""
    import torch

    from znicz_torch.client import FusedClient
    from znicz_torch.network_common import handshake_request
    from znicz_torch.parallel.mesh import distributed_init

    torch.set_num_threads(1)
    distributed_init(f"file://{store}", world, rank, backend="gloo",
                     device="cpu")
    dp, mp = spec["shape"]
    with port_config("mnist", CFG, train_shard=True, mesh__data=dp,
                     mesh__model=mp, job_prefetch=False):
        wf = _mnist_workflow(os.path.join(outdir, f"snap{rank}"))
        client = FusedClient(wf, endpoint=spec["endpoint"],
                             slave_id=spec["slave_id"])
        rec = {"rank": client.rank, "mesh_shape": client.mesh_shape,
               "handshake": handshake_request(wf, mesh=client.mesh_shape),
               "shapes": {f.name: {k: tuple(p.shape) for k, p in
                                   client._trainer._params_of(f).items()}
                          for f in client._trainer._weighted()}}
        if not spec.get("build_only"):
            rec["done"] = client.run(**spec.get("run", {}))
            rec["jobs_done"] = client.jobs_done
            rec["mesh_seconds"] = client.mesh_seconds
            rec["train_steps"] = client._trainer.stats["train_steps"]
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def spawn(tmp_path, shape, endpoint, slave_id, run=None,
          build_only=False) -> list:
    """The meshed slave's ranks, spawned and joined; each rank's
    record.  ``build_only``: the ranks build the ``FusedClient`` and
    leave without running it."""
    outdir = tmp_path / f"ranks_{shape[0]}x{shape[1]}"
    outdir.mkdir()
    world = shape[0] * shape[1]
    spec = {"shape": list(shape), "endpoint": endpoint,
            "slave_id": slave_id, "run": run or {},
            "build_only": build_only}
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(outdir / "store"), str(outdir), json.dumps(spec)],
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


def _master(tmp_path, **kw):
    from znicz_torch.server import Server

    with port_config("mnist", CFG):
        return Server(_mnist_workflow(str(tmp_path / "master")),
                      job_timeout=60.0, **kw).start()


def _tree(wf):
    from znicz_torch.weights import params_to_numpy

    return params_to_numpy(wf)


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """A master and one single-device ``FusedClient`` (prefetch off):
    the master's tree, its jobs and the slave's handshake."""
    from znicz_torch.client import FusedClient
    from znicz_torch.network_common import handshake_request

    tmp = tmp_path_factory.mktemp("one")
    server = _master(tmp)
    with port_config("mnist", CFG, job_prefetch=False):
        wf = _mnist_workflow(str(tmp / "slave"))
        slave = FusedClient(wf, endpoint=server.endpoint, slave_id="one")
        assert slave.mesh_shape is None
        slave.run()
    assert server.join(BUDGET)
    return {"tree": _tree(server.workflow), "jobs": server.jobs_done,
            "handshake": handshake_request(wf)}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["d2", "m2"])
def test_meshed_slave_trains_in_the_band_of_one_device(shape, one_device,
                                                       tmp_path):
    server = _master(tmp_path)
    ranks = spawn(tmp_path, shape, server.endpoint, "m0")
    assert server.join(BUDGET)
    want_mesh = {"data": shape[0], "model": shape[1]}
    assert server.slave_meshes == {"m0": want_mesh}
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["mesh_shape"] == want_mesh
        assert r["handshake"]["mesh"] == want_mesh
        # the digest of the whole graph, as one device's
        assert r["handshake"]["workflow_digest"] == \
            one_device["handshake"]["workflow_digest"]
        fc = next(n for n, leaves in r["shapes"].items()
                  if leaves["weights"][0] == 1024 // shape[1])
        assert r["shapes"][fc]["weights"] == (1024 // shape[1], 784)
    # rank 0 worked for the master, rank 1 stepped on the same jobs
    assert server.jobs_by_slave == {"m0": one_device["jobs"]}
    assert ranks[0]["done"] == ranks[1]["done"] == one_device["jobs"]
    assert ranks[0]["train_steps"] == ranks[1]["train_steps"] > 0
    n_jobs = one_device["jobs"]
    assert len(ranks[1]["mesh_seconds"]["broadcast"]) == n_jobs
    assert len(ranks[0]["mesh_seconds"]["gather"]) == \
        ranks[0]["train_steps"]
    got, want = _tree(server.workflow), one_device["tree"]
    start = _tree(_mnist_master_start(tmp_path))
    for name, leaves in want.items():
        for k, w in leaves.items():
            assert not np.array_equal(start[name][k], w)
            np.testing.assert_allclose(got[name][k], w, **W_TOL,
                                       err_msg=f"{name}.{k}")
    assert server.jobs_ledger()["balanced"]
    # the reference's meshed slave on the same layout, job for job
    ref_jobs, ref_tree = reference_meshed_master(shape, tmp_path)
    assert ref_jobs == server.jobs_done
    for name, leaves in ref_tree.items():
        for k, w in leaves.items():
            np.testing.assert_allclose(got[name][k], w, **W_TOL,
                                       err_msg=f"reference {name}.{k}")


def _mnist_master_start(tmp_path):
    with port_config("mnist", CFG):
        return _mnist_workflow(str(tmp_path / "fresh"))


_REFERENCE = {}


def reference_meshed_master(shape, tmp_path):
    """(jobs done, the master's whole weights) of the reference's pairing:
    its master and its meshed ``FusedClient`` on ``shape`` over
    conftest's virtual devices, prefetch off, the same reduced MNIST; one
    run a shape (``tests/test_shard_training.py:322``)."""
    if shape not in _REFERENCE:
        import threading

        from test_torch_layers import jax_params, jax_sample, sample_config
        from test_torch_master_slave import _jax_server_endpoint

        from znicz_tpu.client import FusedClient as JFusedClient
        from znicz_tpu.core.config import root as jroot
        from znicz_tpu.server import Server as JServer

        eng = jroot.common.engine
        had_mesh = "mesh" in eng
        saved = [(k, jroot.get_by_path(k, _UNSET)) for k in (
            "common.engine.train_shard", "common.engine.job_prefetch",
            "common.engine.mesh.data", "common.engine.mesh.model")]
        try:
            with sample_config("mnist", **CFG):
                jserver = JServer(jax_sample("mnist", tmp_path / "jm"),
                                  endpoint=ANY, job_timeout=60.0)
                thread = threading.Thread(target=jserver.serve, daemon=True)
                thread.start()
                eng.job_prefetch, eng.train_shard = False, True
                eng.mesh.data, eng.mesh.model = shape
                slave = JFusedClient(jax_sample("mnist", tmp_path / "js"),
                                     endpoint=_jax_server_endpoint(jserver),
                                     slave_id="pod")
                slave.run()
                thread.join(BUDGET)
                assert not thread.is_alive()
            assert slave.mesh_shape == {"data": shape[0], "model": shape[1]}
        finally:
            for path, old in saved:
                head, _, leaf = path.rpartition(".")
                if old is not _UNSET:
                    jroot.set_by_path(path, old)
                elif jroot.get_by_path(head) is not None:
                    delattr(jroot.get_by_path(head), leaf)
            if not had_mesh:
                delattr(eng, "mesh")
        _REFERENCE[shape] = (jserver.jobs_done, jax_params(jserver.workflow))
    return _REFERENCE[shape]


@pytest.mark.slow
def test_meshed_slave_through_relay_soak(tmp_path):
    """A meshed leaf behind a relay trains to completion, and the relay's
    manifest credits its jobs to it."""
    from znicz_torch.parallel.chaos import RelayHarness

    server = _master(tmp_path)
    harness = RelayHarness(server.endpoint, ANY, relay_id="r0",
                           recv_timeout=1.0, max_reconnects=60)
    harness.start()
    try:
        ranks = spawn(tmp_path, (1, 2), harness.endpoint, "pod0",
                      run=dict(recv_timeout=1.0, max_reconnects=80,
                               backoff_base=0.05, backoff_cap=0.4,
                               connect_retries=80))
        assert server.join(BUDGET)
    finally:
        harness.kill()
    assert ranks[0]["mesh_shape"] == {"data": 1, "model": 2}
    assert bool(server.workflow.decision.complete)
    assert server.jobs_by_slave.get("pod0", 0) > 0
    assert server.aggregated_updates >= 1
    assert "r0" in server.relays


_UNSET = object()
#: what the CLI sets in the port's config before it refuses a mesh
CLI_KEYS = ("common.engine.mode", "common.engine.slave_endpoint",
            "common.engine.train_shard", "common.engine.mesh.data",
            "common.engine.mesh.model", "common.serving.mesh.data",
            "common.serving.mesh.model")


def test_cli_meshed_slave_needs_torchrun():
    from znicz_torch.__main__ import main
    from znicz_torch.core.config import root

    saved = [(k, root.get_by_path(k, _UNSET)) for k in CLI_KEYS]
    try:
        for argv in (["mnist", "--device", "cpu", "--slave",
                      "tcp://127.0.0.1:1", "--mesh-data", "2"],
                     ["mnist", "--device", "cpu", "--serve", ANY,
                      "--mesh-model", "2"],
                     ["mnist", "--device", "cpu", "--mesh-data", "2"]):
            assert main(argv) == 2, argv
    finally:
        for path, old in saved:
            head, _, leaf = path.rpartition(".")
            if old is _UNSET:
                node = root.get_by_path(head)
                if node is not None and leaf in node:
                    delattr(node, leaf)
            else:
                root.set_by_path(path, old)


def test_cli_meshed_slave_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m znicz_torch mnist
    --fused --slave EP --mesh-data 2``: both ranks exit 0 and the master
    records the slave's mesh."""
    server = _master(tmp_path)
    over = [f"root.mnist.{k.replace('__', '.')}={v!r}"
            for k, v in CFG.items()]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "znicz_torch", "mnist", "--device",
         "cpu", "--fused", "--slave", server.endpoint, "--mesh-data", "2",
         f"root.common.dirs.snapshots={tmp_path}", *over],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=BUDGET)
    assert out.returncode == 0, out.stderr[-4000:]
    assert server.join(BUDGET)
    assert list(server.slave_meshes.values()) == [{"data": 2, "model": 1}]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    assert all(x["train_steps"] == server.jobs_done for x in lines)
    assert re.fullmatch(r"[0-9a-f]{8}", next(iter(server.jobs_by_slave)))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           json.loads(sys.argv[5]))
