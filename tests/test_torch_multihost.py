"""Two processes join one gloo group through the JAX package's launch
variables (ADANERF_COORD, ADANERF_NPROC, ADANERF_PROC_ID; the recipe in
adanerf_tpu_torch/parallel/mesh.py) and train through the port's entry
point, ``python -m adanerf_tpu_torch.train --device cpu``, for 4 epochs:
counterpart of tests/test_multihost.py. Both must exit 0, rank 0 alone
writes files (each process is given a log directory of its own), and the
final weights equal a one-process run's within JAX's bars for the sharded
step (tests/test_parallel.py: rtol 2e-5, atol 2e-6)."""

import os
import socket
import subprocess
import sys

import numpy as np

from scene_utils import dense_config_args, make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 4


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _args(scene, log):
    return dense_config_args(scene, log, epochs=EPOCHS) + [
        "--meshDevices", "-1", "--epochsRender", "100000", "--epochsValidate", "100000",
        "--epochsCheckpoint", "100000", "--nonVerbose", "--randomSeed", "7", "--device", "cpu"]


def _run(args, env):
    cmd = [sys.executable, "-m", "adanerf_tpu_torch.train"] + args
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _final_weights(logdir):
    files = sorted(logdir.rglob(f"*_{EPOCHS - 1:07d}.weights"))
    assert files, f"no final checkpoints under {logdir}"
    out = {}
    for wfile in files:
        with np.load(wfile) as data:
            out.update({f"{wfile.name}/{k}": data[k] for k in data.files})
    return out


def test_two_process_rendezvous(tmp_path):
    scene = make_scene(str(tmp_path / "scene"))
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    procs = []
    for i in range(2):
        env = dict(base, ADANERF_COORD=f"localhost:{port}", ADANERF_NPROC="2",
                   ADANERF_PROC_ID=str(i), OMP_NUM_THREADS="2")
        procs.append(_run(_args(scene, str(tmp_path / f"logs{i}")), env))
    procs.append(_run(_args(scene, str(tmp_path / "alone")), dict(base, OMP_NUM_THREADS="2")))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"

    assert "data-parallel over 2 ranks (rays axis, gloo)" in outs[0], outs[0][-4000:]
    assert "data-parallel" not in outs[2]
    written = [f for f in (tmp_path / "logs1").rglob("*") if f.is_file()]
    assert written == [], written
    final, alone = _final_weights(tmp_path / "logs0"), _final_weights(tmp_path / "alone")
    assert final.keys() == alone.keys()
    for k in final:
        np.testing.assert_allclose(final[k], alone[k], rtol=2e-5, atol=2e-6, err_msg=k)


_JOIN = """
import sys, time
from adanerf_tpu_torch.parallel import mesh
rank = mesh.init_multi_host("cpu")
if rank == 1:
    time.sleep(3.0)  # still running when rank 0 is done
mesh.leave_group()
print("left", rank, flush=True)
"""


def test_a_launched_rank_outlives_rank_0_and_exits_cleanly():
    """Rank 1 joins through mesh.init_multi_host and is still working when
    rank 0 (which hosts the tcp:// store) is done; the trainer's exit path,
    mesh.leave_group, keeps rank 0 until rank 1 has left, and both exit 0
    (a rank whose store went first aborted at exit, SIGABRT)."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", _JOIN], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(base, ADANERF_COORD=f"localhost:{port}",
                                       ADANERF_NPROC="2", ADANERF_PROC_ID=str(i)))
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} exited {p.returncode}:\n{out[-4000:]}"
        assert f"left {i}" in out, out
