"""CLI parity: `python -m libaec_tpu.cli` must produce byte-identical files
to the reference `aec` binary (/root/reference/src/aec.c) for encode and
decode across flag sets, including non-RSI-aligned input sizes."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import gen
from libaec_tpu import Config

REPO = Path(__file__).resolve().parent.parent
REF_AEC = REPO / ".refbuild" / "src" / "aec"

pytestmark = pytest.mark.skipif(not REF_AEC.exists(),
                                reason="reference aec binary not built")


def _run_ours(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # small files take the native codec
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-m", "libaec_tpu.cli"] + args,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res


CASES = [
    (["-n", "16", "-j", "64", "-r", "256", "-m"], 16, 0x0C),
    (["-n", "8", "-j", "16", "-r", "64"], 8, 0x08),
    (["-n", "32", "-j", "32", "-r", "32", "-m", "-s"], 32, 0x0D),
    (["-n", "24", "-j", "16", "-r", "16", "-3", "-m"], 24, 0x0E),
    (["-n", "4", "-j", "8", "-r", "16", "-t"], 4, 0x18),
]


@pytest.mark.parametrize("flags,bps,cfg_flags", CASES)
def test_cli_encode_decode_parity(tmp_path, flags, bps, cfg_flags):
    cfg = Config(bps, int(flags[flags.index("-j") + 1]),
                 int(flags[flags.index("-r") + 1]), cfg_flags)
    rng = np.random.default_rng(bps)
    n = cfg.samples_per_rsi * 5 + cfg.block_size * 3 + 1  # ragged tail
    vals = gen.gen_values(rng, n, bps, cfg.signed, "lowentropy")
    src = tmp_path / "src.dat"
    src.write_bytes(gen.pack_samples(vals, bps, cfg.flags))

    ours_rz = tmp_path / "ours.rz"
    ref_rz = tmp_path / "ref.rz"
    _run_ours(flags + [str(src), str(ours_rz)])
    subprocess.run([str(REF_AEC)] + flags + [str(src), str(ref_rz)],
                   check=True, timeout=300)
    assert ours_rz.read_bytes() == ref_rz.read_bytes()

    ours_dec = tmp_path / "ours.dat"
    _run_ours(["-d"] + flags + [str(ref_rz), str(ours_dec)])
    ref_dec = tmp_path / "ref.dat"
    subprocess.run([str(REF_AEC), "-d"] + flags + [str(ours_rz),
                                                   str(ref_dec)],
                   check=True, timeout=300)
    # cross-decode (ours on ref's stream and vice versa): full byte equality,
    # including the identically-padded ragged tail
    a, b = ours_dec.read_bytes(), ref_dec.read_bytes()
    assert a == b


def test_cli_buffer_size_flag(tmp_path):
    """-b sizes the internal chunking (aec.c:149-156); output bytes must be
    identical for any -b, including one smaller than a single RSI."""
    flags = ["-n", "16", "-j", "16", "-r", "32", "-m"]
    cfg = Config(16, 16, 32, 0x0C)
    rng = np.random.default_rng(99)
    n = cfg.samples_per_rsi * 7 + 5
    src = tmp_path / "src.dat"
    src.write_bytes(gen.pack_samples(
        gen.gen_values(rng, n, 16, False, "lowentropy"), 16, cfg.flags))

    outs = []
    for b in ["64", "4096", "10485760"]:
        rz = tmp_path / f"b{b}.rz"
        _run_ours(flags + ["-b", b, str(src), str(rz)])
        outs.append(rz.read_bytes())
    assert outs[0] == outs[1] == outs[2]

    ref_rz = tmp_path / "ref.rz"
    subprocess.run([str(REF_AEC)] + flags + [str(src), str(ref_rz)],
                   check=True, timeout=300)
    assert outs[0] == ref_rz.read_bytes()

    # decode emits the encoder's repeat-last-sample padding of the ragged
    # tail, so compare against the reference binary's decode, not src
    ref_dec = tmp_path / "ref.dat"
    subprocess.run([str(REF_AEC), "-d"] + flags + [str(ref_rz),
                                                   str(ref_dec)],
                   check=True, timeout=300)
    for b in ["64", "10485760"]:
        dec = tmp_path / f"d{b}.dat"
        _run_ours(["-d"] + flags + ["-b", b, str(ref_rz), str(dec)])
        assert dec.read_bytes() == ref_dec.read_bytes()
