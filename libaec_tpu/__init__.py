"""libaec_tpu: a lossless CCSDS 121.0-B-2 / SZIP codec in JAX.

A from-scratch JAX/XLA re-design of the capabilities of libaec
(Golomb-Rice adaptive entropy coding): data-parallel encode over RSI batches,
two-phase indexed decode, bit-exact interoperability with the reference
bitstreams, plus the szlib compatibility surface and a CLI.
"""
from .constants import (  # noqa: F401
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_FLUSH,
    AEC_NO_FLUSH,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
    AEC_CONF_ERROR,
    AEC_DATA_ERROR,
    AEC_MEM_ERROR,
    AEC_STREAM_ERROR,
    AecConfError,
    AecDataError,
    AecError,
    AecMemError,
    AecStreamError,
)
from .config import Config  # noqa: F401
from .decode import (  # noqa: F401
    decode_buffer,
    decode_buffer_status,
    decode_buffer_tpu,
    decode_buffers_tpu,
)
from .encode import encode_buffer, encode_buffer_status  # noqa: F401

__version__ = "0.1.0"
