"""The production jitted chunk encoder (encode._jax_chunk_fn: XLA field
pipeline + grouped packer + big-endian word layout) must reproduce the
numpy pipeline -- checked against the reference C library -- bit for bit,
including the outgoing warm-start k, across widths, flag sets and data
regimes."""
import numpy as np
import pytest

from libaec_tpu import Config
from libaec_tpu.backend import NUMPY
from libaec_tpu.constants import (
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
)
from libaec_tpu.encode import (
    _jax_chunk_fn,
    pipeline_fields,
    words_to_stream_bytes,
)
from libaec_tpu.ops import bitpack

FLAG_SETS = [
    0,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED | AEC_DATA_PREPROCESS,
]
KINDS = ["random", "low", "zeros", "jump", "mixed"]


def gen_data(rng, cfg, n_rsi, kind):
    S = cfg.samples_per_rsi
    bps = cfg.bits_per_sample
    hi = (1 << bps) - 1
    if kind == "random":
        x = rng.integers(0, hi + 1, size=(n_rsi, S), dtype=np.uint64)
    elif kind == "low":
        base = rng.integers(0, max(1, hi // 4), size=(n_rsi, 1),
                            dtype=np.uint64)
        x = base + rng.integers(0, 4, size=(n_rsi, S), dtype=np.uint64)
        x = np.minimum(x, hi)
    elif kind == "zeros":
        x = np.zeros((n_rsi, S), np.uint64)
        x[:, -cfg.block_size:] = rng.integers(0, hi + 1, cfg.block_size)
    elif kind == "jump":
        x = np.zeros((n_rsi, S), np.uint64)
        x[:, S // 2:] = hi
    else:  # mixed runs
        zmask = rng.random((n_rsi, cfg.rsi)) < 0.7
        full = rng.integers(0, hi + 1, size=(n_rsi, S), dtype=np.uint64)
        x = np.where(np.repeat(zmask, cfg.block_size, axis=1), 0, full)
    return x.astype(np.uint32)


def numpy_stream(cfg, x, k_init):
    """(stream bytes, total bits, k_final) from the numpy pipeline."""
    w, v, k_final = pipeline_fields(NUMPY, cfg, x, cfg.rsi, k_init)
    packed, total_bits = bitpack.pack_fields(NUMPY, w, v, 0)
    return packed.tobytes(), total_bits, int(k_final)


def check_chunk(cfg, x, k_init=0):
    want, bits_np, k_np = numpy_stream(cfg, x, k_init)
    words, total_bits, k_final = _jax_chunk_fn(cfg, x.shape[0], cfg.rsi)(
        x, k_init, 0)
    got = words_to_stream_bytes(words, int(total_bits)).tobytes()
    assert int(total_bits) == bits_np
    assert int(k_final) == k_np
    assert got == want


@pytest.mark.parametrize("bps", [4, 8, 13, 16, 24, 32])
@pytest.mark.parametrize("flags", FLAG_SETS)
def test_chunk_matrix(bps, flags):
    """Every data regime as consecutive RSIs of one chunk, so each case
    compiles one program; the block size and RSI vary across cases."""
    rng = np.random.default_rng(bps * 977 + flags)
    bs = int(rng.choice([8, 16, 32, 64]))
    rsi = int(rng.choice([16, 32, 64, 128]))
    cfg = Config(bps, bs, rsi, flags)
    x = np.concatenate([gen_data(rng, cfg, 2, kind) for kind in KINDS])
    check_chunk(cfg, x, int(rng.integers(0, max(1, cfg.kmax))))


def test_chunk_long_zero_and_ros():
    cfg = Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    S = cfg.samples_per_rsi
    x = np.zeros((4, S), np.uint32)
    # RSI 0: all zero (ROS markers); RSI 1: 63-block run then data;
    # RSI 2: alternating zero/nonzero blocks; RSI 3: random
    x[1, 63 * 64:] = 7
    x[2] = np.where((np.arange(S) // 64) % 2 == 0, 0, 1000)
    x[3] = np.random.default_rng(0).integers(0, 1 << 16, S)
    check_chunk(cfg, x)
