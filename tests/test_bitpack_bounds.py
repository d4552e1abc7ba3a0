"""Regression: the grouped (device) packer's per-block window must hold the
widest possible CDS.  A zero run emitted mid-segment spans up to 63 blocks
(fsval 63 -> 64-bit unary field, encode.c:574-579), which exceeds
block_size*bits_per_sample for small blocks / narrow samples; sizing the
window from the uncompressed CDS alone silently dropped bits."""
import numpy as np
import pytest

from libaec_tpu import Config
from libaec_tpu.backend import NUMPY as B
from libaec_tpu.constants import AEC_DATA_PREPROCESS
from libaec_tpu.encode import pipeline_fields, worst_case_bits_per_block
from libaec_tpu.ops import bitpack


@pytest.mark.parametrize("bps,bs", [(1, 8), (2, 8), (4, 8), (8, 8), (1, 16)])
def test_long_zero_run_window(bps, bs):
    cfg = Config(bps, bs, 64, AEC_DATA_PREPROCESS)
    S = cfg.samples_per_rsi
    # 63 zero blocks then a nonzero block: the run ends mid-segment with
    # n_run == 63 -> a 64-bit FS field in one block's window
    x = np.zeros((1, S), np.uint32)
    x[0, 63 * bs:] = 1
    w, v, _ = pipeline_fields(B, cfg, x, cfg.rsi, 0)
    packed, total_bits = bitpack.pack_fields(B, w, v, 0)

    worst = worst_case_bits_per_block(cfg)
    local_words = (worst + 31) // 32 + 1
    NB = cfg.rsi
    group = 64
    gw1 = group * (local_words + 1) + 1
    nwords = (NB * worst + 8) // 32 + gw1 + 2
    words, tb = bitpack.pack_fields_grouped(
        B, w.reshape(NB, -1), v.reshape(NB, -1), 0, local_words, nwords,
        group)
    by = np.asarray(words).astype(">u4").view(np.uint8)
    got = by[4:4 + (int(tb) + 7) // 8].tobytes()
    assert int(tb) == total_bits
    assert got == packed.tobytes()
