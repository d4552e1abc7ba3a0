"""Multi-controller (multi-host-shaped) execution: 2 jax.distributed
processes x 4 virtual CPU devices each form one 8-device mesh.  The
sharded encode and two-phase decode run SPMD across the processes --
process-local shard arrays, cross-process collectives (the all_gather
k-map chain / offset prefix-sum now ride the distributed runtime), and
per-process output IO -- and must be bit-identical to the single-process
stream (asserted inside each worker) with the per-process shard files
stitching back to the original bytes (asserted here).

This exercises the multi-host axis of SURVEY.md §2's "sharded across
chips and hosts": a multi-host deployment runs this exact program shape
with processes on different hosts."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
NPROC = 2
LOCAL_DEVICES = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}")
    port = _free_port()

    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "mp_worker.py"),
             str(pid), str(NPROC), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"MP-OK {pid}" in out, (
            f"worker {pid} failed (rc={rc})\n--- stdout:\n{out}"
            f"\n--- stderr:\n{err[-4000:]}")

    # stitch each process's addressable-shard files back together; with a
    # row-sharded 8-device mesh, process 0 owns rows [0, N/2) and process
    # 1 rows [N/2, N): concatenation in pid order is the global stream
    for seed in (0, 1):
        raw = (tmp_path / f"raw_{seed}.bin").read_bytes()
        dec = b"".join(
            (tmp_path / f"dec_{seed}_{pid}.bin").read_bytes()
            for pid in range(NPROC))
        assert dec == raw, f"case {seed}: stitched per-process IO differs"
