"""Device config matrix: encode_buffer through the jax pipeline and
decode_buffer_tpu across sample widths 2..32, signed/unsigned, MSB/LSB,
preprocess on/off, the 3-byte layout, restricted mode, a non-CCSDS block
size, rsi=1 and RSI padding -- bit-identical to the numpy encoder and the
native decoder (tests/device_matrix.py).

The unmarked cases run the XLA programs on whatever device JAX defaults
to (the CPU backend in tier-1); the gpu-marked copy runs the same points
on a GPU and skips elsewhere."""
import pytest

from device_matrix import MATRIX, run_point
from libaec_tpu import native

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native library unavailable")


@pytest.mark.parametrize("bps,bs,rsi,flags,n_rsi", MATRIX)
def test_device_matrix_point(bps, bs, rsi, flags, n_rsi):
    run_point(bps, bs, rsi, flags, n_rsi)


@pytest.mark.gpu
@pytest.mark.parametrize("bps,bs,rsi,flags,n_rsi", MATRIX)
def test_device_matrix_point_gpu(gpu_device, bps, bs, rsi, flags, n_rsi):
    run_point(bps, bs, rsi, flags, n_rsi)
