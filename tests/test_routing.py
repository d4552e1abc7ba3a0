"""Where work runs: the default encode/decode routes follow JAX's default
platform, a JAX that fails raises instead of falling back to the CPU, the
device decoder refuses to run without the native scan, the compile cache
follows JAX_COMPILATION_CACHE_DIR, and chip_smoke.py refuses to run
without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import gen
from libaec_tpu import Config, backend, decode, encode, native
from libaec_tpu.constants import AEC_DATA_MSB, AEC_DATA_PREPROCESS

REPO = Path(__file__).resolve().parent.parent
CFG = Config(16, 64, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS)


def _stream():
    rng = np.random.default_rng(12)
    raw = gen.pack_samples(gen.gen_values(
        rng, CFG.samples_per_rsi * 3, 16, False, "lowentropy"), 16, CFG.flags)
    return raw, encode.encode_buffer(raw, CFG)


@pytest.mark.parametrize("platform,on_device", [("gpu", True),
                                                ("cpu", False)])
def test_routes_follow_platform(monkeypatch, platform, on_device):
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    raw, comp = _stream()
    monkeypatch.delenv("LIBAEC_TPU_DECODE", raising=False)
    monkeypatch.delenv("LIBAEC_TPU_ENCODE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert encode._native_encode_wanted(
        encode.AUTO_JAX_MIN_BYTES) is not on_device
    assert encode._native_encode_wanted(
        encode.AUTO_JAX_MIN_BYTES - 1) is True
    assert decode._device_decode_wanted(
        decode.DEVICE_DECODE_MIN_BYTES) is on_device

    calls = []
    real_dev, real_cpu = decode.decode_buffer_tpu, decode._decode_cpu_status
    monkeypatch.setattr(decode, "DEVICE_DECODE_MIN_BYTES", 0)
    monkeypatch.setattr(decode, "decode_buffer_tpu", lambda *a: (
        calls.append("device"), real_dev(*a))[1])
    monkeypatch.setattr(decode, "_decode_cpu_status", lambda *a: (
        calls.append("cpu"), real_cpu(*a))[1])
    assert decode.decode_buffer(comp, CFG, len(raw)) == raw
    assert calls == ["device" if on_device else "cpu"]


@pytest.mark.parametrize("route", ["encode", "decode"])
def test_broken_jax_raises(monkeypatch, route):
    def broken():
        raise RuntimeError("backend failed to initialise")

    monkeypatch.delenv("LIBAEC_TPU_DECODE", raising=False)
    monkeypatch.delenv("LIBAEC_TPU_ENCODE", raising=False)
    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="initialise"):
        if route == "encode":
            encode._native_encode_wanted(encode.AUTO_JAX_MIN_BYTES)
        else:
            decode._device_decode_wanted(decode.DEVICE_DECODE_MIN_BYTES)


def test_device_decode_needs_native(monkeypatch):
    raw, comp = _stream()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native scan"):
        decode.decode_buffer_tpu(comp, CFG, len(raw))
    with pytest.raises(RuntimeError, match="native scan"):
        decode.decode_buffers_tpu([comp], CFG, [len(raw)])


def test_gpu_without_native_decodes_on_cpu(monkeypatch):
    """The device route needs the native scan, so without the library the
    default route stays on the CPU decoder even on an accelerator."""
    raw, comp = _stream()
    monkeypatch.delenv("LIBAEC_TPU_DECODE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(decode, "DEVICE_DECODE_MIN_BYTES", 0)
    assert decode._device_decode_wanted(len(raw)) is False
    assert decode.decode_buffer(comp, CFG, len(raw)) == raw


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the codec sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert backend.configure_compile_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """Without a GPU (here JAX is held to the CPU) the smoke script exits
    non-zero and prints no result line -- also from a directory holding
    only the script."""
    if where == "checkout":
        script, cwd = REPO / "chip_smoke.py", REPO
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", script)
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
