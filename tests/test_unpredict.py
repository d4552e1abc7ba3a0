"""The device inverse predictor (ops/unpredict.unpredict_rsis) and byte
layout (samples_to_bytes_device) against the scalar decoder's FLUSH and
put_* equivalents (decode._unpredict, decode._put_bytes)."""
import numpy as np
import pytest

from libaec_tpu import Config
from libaec_tpu.constants import (
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
)
from libaec_tpu.decode import _put_bytes, _unpredict

CASES = [
    (Config(16, 64, 32, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 16),
    (Config(16, 64, 32,
            AEC_DATA_MSB | AEC_DATA_SIGNED | AEC_DATA_PREPROCESS), 16),
    (Config(8, 8, 16, AEC_DATA_PREPROCESS), 24),
    (Config(32, 64, 8, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 8),
]
IDS = ["u16msb", "s16msb", "u8lsb", "u32msb"]


def _deltas(case):
    cfg, n_rsi = CASES[case]
    rng = np.random.default_rng(case)
    return cfg, rng.integers(0, 1 << min(cfg.bits_per_sample, 31),
                             (n_rsi, cfg.samples_per_rsi), dtype=np.uint32)


def _scalar_samples(cfg, deltas):
    return np.stack([_unpredict(row, True, 0, cfg)[0] for row in deltas])


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_unpredict_rsis_matches_scalar(case):
    import jax

    from libaec_tpu.ops.unpredict import unpredict_rsis

    cfg, deltas = _deltas(case)
    got = np.asarray(jax.jit(lambda d: unpredict_rsis(cfg, d))(deltas))
    assert np.array_equal(got, _scalar_samples(cfg, deltas))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_samples_to_bytes_matches_scalar(case):
    import jax

    from libaec_tpu.ops.unpredict import samples_to_bytes_device

    cfg, deltas = _deltas(case)
    samples = _scalar_samples(cfg, deltas).reshape(-1)
    got = np.asarray(jax.jit(
        lambda s: samples_to_bytes_device(cfg, s))(samples))
    want = b"".join(_put_bytes(int(v), cfg.bytes_per_sample, cfg.msb)
                    for v in samples)
    assert got.view(np.uint8).tobytes() == want
