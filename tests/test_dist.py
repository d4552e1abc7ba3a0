"""Shard-count invariance: the mesh encoder's assembled stream must be
bit-identical to the single-chip stream.  Runs in a subprocess with a
virtual 8-device CPU platform (the device count must be set before JAX
starts)."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.path.insert(0, %r)
import importlib.util
spec = importlib.util.spec_from_file_location("ge", %r)
ge = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ge)
ge.dryrun_multichip(8)
ge.dryrun_multichip(2)
print("SHARD-INVARIANT-OK")
"""


def test_dryrun_multichip_cpu8():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    script = SCRIPT % (str(REPO), str(REPO / "__graft_entry__.py"))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "SHARD-INVARIANT-OK" in res.stdout, res.stdout + res.stderr
