"""The device config matrix: encode and decode through the production
device paths across the flag x width matrix, bit-exact against the numpy
encoder (checked against the reference C library) and the native decoder.

Shared by tests/test_device_matrix.py (XLA on the CPU backend, and the
same points on a GPU) and chip_smoke.py.

Signed cases compare device decode against the native core, not the raw
input: the inverse predictor emits sign-extended samples (reference
decode.c:80-85 semantics), so a synthetic input without sign extension
round-trips to its canonical form -- on the reference binary too.
"""
import numpy as np

import gen
from libaec_tpu import Config, native
from libaec_tpu.backend import NUMPY, jax_backend
from libaec_tpu.constants import (
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)

# (bps, block_size, rsi, flags, n_rsi) -- sample widths 2..32,
# signed/unsigned, MSB/LSB, preprocess on/off, 3-byte layout, block sizes
# 8..64, restricted mode, a non-CCSDS block size, rsi=1 and RSI padding.
MATRIX = [
    (16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS, 8),   # bench shape
    (8, 16, 32, AEC_DATA_PREPROCESS, 8),                    # 8-bit LSB
    (13, 32, 16, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS, 8),  # odd width
    (32, 64, 8, AEC_DATA_MSB | AEC_DATA_PREPROCESS, 8),     # full width
    (16, 8, 64, 0, 8),                                      # no-PP, bs=8
    (24, 64, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS
     | AEC_DATA_3BYTE, 8),                                  # 3-byte layout
    (2, 8, 16, AEC_RESTRICTED | AEC_DATA_PREPROCESS, 8),    # restricted
    (16, 10, 32, AEC_DATA_MSB | AEC_DATA_PREPROCESS
     | AEC_NOT_ENFORCE, 8),                                 # even bs=10
    (16, 64, 1, AEC_DATA_MSB | AEC_DATA_PREPROCESS, 64),    # rsi=1 edge
    (16, 64, 32, AEC_DATA_MSB | AEC_DATA_PREPROCESS
     | AEC_PAD_RSI, 8),                                     # PAD_RSI
]


def gen_raw(cfg, n_rsi, seed):
    """Mixed-entropy samples in canonical stored form (signed data is
    sign-extended into its container, as the format stores it), with
    zero runs sprinkled in so the low-entropy options are exercised."""
    rng = np.random.default_rng(seed)
    n = n_rsi * cfg.samples_per_rsi
    vals = gen.gen_values(rng, n, cfg.bits_per_sample, cfg.signed,
                          "midentropy")
    nb = n // cfg.block_size
    zmask = rng.random(nb) < 0.3
    vals = np.where(np.repeat(zmask, cfg.block_size), 0, vals)
    return gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)


def run_point(bps, bs, rsi, flags, n_rsi):
    """Encode and decode one matrix point on the JAX default device and
    assert bit-identity; also assert that the device programs ran."""
    from libaec_tpu.decode import _DEC_JIT_CACHE, decode_buffer_tpu
    from libaec_tpu.encode import _JIT_CACHE, encode_buffer

    cfg = Config(bps, bs, rsi, flags)
    raw = gen_raw(cfg, n_rsi, seed=bps * 131 + bs + flags)

    comp_np = encode_buffer(raw, cfg, backend=NUMPY)
    comp_dev = encode_buffer(raw, cfg, backend=jax_backend(),
                             rsis_per_chunk=n_rsi)
    assert comp_dev == comp_np, "device encode differs from numpy oracle"
    assert any(k[0] == "bytes" and k[1] == cfg for k in _JIT_CACHE), \
        "device encode program never built"

    st_cpu, out_cpu = native.decode(comp_np, len(raw), cfg)
    st_dev, out_dev = decode_buffer_tpu(comp_np, cfg, len(raw))
    assert (st_dev, out_dev) == (st_cpu, out_cpu), \
        "device decode differs from the native core"
    assert any(k[0] == cfg for k in _DEC_JIT_CACHE), \
        "device decode program never built"
    if not cfg.signed:
        assert out_dev == raw  # unsigned canonical input round-trips
