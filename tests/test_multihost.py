"""Multi-host runtime: 2-process CPU integration + mesh construction.

The subprocess test runs the REAL ``jax.distributed`` coordination path: two
OS processes, each with 4 virtual CPU devices, form one 8-device global mesh
and execute the landmark-sharded LM solve with cross-process collectives
(VERDICT r2 item 4; SURVEY.md section 7 step 7 "DCN across hosts").
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["baseline", "halo"])
def test_two_process_distributed_solve(mode):
    """baseline: partitioner-lowered all-gather solve; halo: the production
    Morton/halo shard_map PCG whose boundary-row psum crosses the process
    boundary (VERDICT r3 item 4) -- with a device-count-indivisible N so the
    pad_pair path is exercised on the global mesh."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "TIDS_COORDINATOR": f"localhost:{port}",
            "TIDS_NUM_PROCESSES": "2",
            "TIDS_PROCESS_ID": str(pid),
            "TIDS_WORKER_MODE": mode,
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "triangulation_in_deformable_scenes_tpu.parallel.multihost_worker"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err[-3000:]}"

    results = [json.loads((out.strip().splitlines())[-1]) for out, _ in outs]
    by_pid = {r["process_id"]: r for r in results}
    assert set(by_pid) == {0, 1}
    for r in results:
        assert r["num_processes"] == 2
        assert r["global_devices"] == 8
        assert r["local_devices"] == 4
        assert r["descended"]
    # SPMD: both processes computed the identical global result.
    assert by_pid[0]["final_cost"] == pytest.approx(by_pid[1]["final_cost"], rel=1e-6)
    assert by_pid[0]["initial_cost"] == pytest.approx(by_pid[1]["initial_cost"], rel=1e-6)


def test_multihost_mesh_single_process():
    """In a single process the ("pairs", "points") mesh degenerates to one
    row holding all local devices; points never cross a process boundary."""
    import jax

    from triangulation_in_deformable_scenes_tpu.parallel import multihost

    mesh = multihost.multihost_mesh()
    assert mesh.axis_names == ("pairs", "points")
    assert mesh.devices.shape == (1, len(jax.devices()))

    pmesh = multihost.points_submesh()
    assert pmesh.devices.size == len(jax.devices())


def test_initialize_noop_without_config(monkeypatch):
    """No coordinator configured -> initialize() must be a harmless no-op
    (single-process runs keep working with the same entrypoint)."""
    from triangulation_in_deformable_scenes_tpu.parallel import multihost

    monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
    monkeypatch.delenv(multihost.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(multihost.ENV_PROCESS_ID, raising=False)
    multihost.initialize()  # must not raise or reconfigure anything
