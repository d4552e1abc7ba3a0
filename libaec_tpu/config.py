"""Static per-stream coding configuration.

Derives the same per-stream parameters the reference computes in
aec_encode_init (/root/reference/src/encode.c:773-907) and aec_decode_init
(/root/reference/src/decode.c:694-795): id_len, bytes_per_sample, xmin/xmax,
kmax. These are *static* (shape-defining) values: every jitted device pipeline
specialises on a Config instance.
"""
from dataclasses import dataclass

from .constants import (
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
    AecConfError,
)

# Width of the per-block k-candidate tables. kmax <= 2^5 - 3 = 29, so 32
# candidate slots always suffice.
KW = 32


@dataclass(frozen=True)
class Config:
    bits_per_sample: int
    block_size: int
    rsi: int
    flags: int = 0

    def __post_init__(self):
        bps = self.bits_per_sample
        if bps == 0 or bps > 32:
            raise AecConfError("bits_per_sample must be in [1, 32]")
        if self.flags & AEC_NOT_ENFORCE:
            # encode.c:780-791: any even block size allowed
            if self.block_size & 1 or self.block_size == 0:
                raise AecConfError("block_size must be even")
        else:
            if self.block_size not in (8, 16, 32, 64):
                raise AecConfError("block_size must be 8, 16, 32 or 64")
        if self.rsi > 4096 or self.rsi == 0:
            raise AecConfError("rsi must be in [1, 4096]")
        if self.restricted and 4 < bps <= 8:
            # encode.c:843-851 / decode.c:739-747: the RESTRICTED check
            # lives only in the bps<=8 branch -- 5..8 is a CONF_ERROR,
            # while bps>8 silently ignores the flag (id_len is picked by
            # width first, so the codec output is identical to plain)
            raise AecConfError("restricted mode requires bits_per_sample <= 4")

    # -- flag accessors ----------------------------------------------------
    @property
    def signed(self):
        return bool(self.flags & AEC_DATA_SIGNED)

    @property
    def msb(self):
        return bool(self.flags & AEC_DATA_MSB)

    @property
    def preprocess(self):
        return bool(self.flags & AEC_DATA_PREPROCESS)

    @property
    def restricted(self):
        return bool(self.flags & AEC_RESTRICTED)

    @property
    def three_byte(self):
        # encode.c:808-817: 3-byte packing applies to 17..24 bit samples
        return bool(self.flags & AEC_DATA_3BYTE) and 16 < self.bits_per_sample <= 24

    @property
    def pad_rsi(self):
        return bool(self.flags & AEC_PAD_RSI)

    # -- derived parameters (encode.c:804-872) -------------------------------
    @property
    def id_len(self):
        bps = self.bits_per_sample
        if bps > 16:
            return 5
        if bps > 8:
            return 4
        if self.restricted:
            return 1 if bps <= 2 else 2
        return 3

    @property
    def bytes_per_sample(self):
        bps = self.bits_per_sample
        if bps > 16:
            return 3 if self.three_byte else 4
        if bps > 8:
            return 2
        return 1

    @property
    def kmax(self):
        # encode.c:872; id_len==1 gives kmax==-1 i.e. splitting disabled
        return (1 << self.id_len) - 3

    @property
    def xmax(self):
        # encode.c:862-870, as uint32
        bps = self.bits_per_sample
        if self.signed:
            # encode.c:863 shifts by (32 - bps + 1); for bps == 1 that is a
            # shift by 32, which x86 masks to 0 -> xmax = UINT32_MAX. We
            # reproduce that quirk for bit-exactness with reference streams.
            return 0xFFFFFFFF >> ((32 - bps + 1) & 31)
        return 0xFFFFFFFF >> (32 - bps)

    @property
    def xmin(self):
        if self.signed:
            return (~self.xmax) & 0xFFFFFFFF
        return 0

    @property
    def mask(self):
        """Low bits_per_sample bits.  Samples are masked to this at
        INGEST (a deliberate deviation: the reference's accessors never
        mask, and its emitters then byte-add out-of-range bits into
        neighbouring fields -- encode.c:61-83's `+=` -- corrupting its
        own bitstream; masking yields the deterministic stream of the
        masked input instead, identical across every backend here, and
        bit-identical to the reference for all in-range input)."""
        bps = self.bits_per_sample
        return 0xFFFFFFFF if bps >= 32 else (1 << bps) - 1

    @property
    def samples_per_rsi(self):
        return self.rsi * self.block_size

    @property
    def rsi_len_bytes(self):
        return self.samples_per_rsi * self.bytes_per_sample

    @property
    def uncomp_len(self):
        """CDS comparison length of a non-reference block (encode.c:802)."""
        return self.block_size * self.bits_per_sample

    @property
    def slots_per_block(self):
        """Static field slots per block in the bit assembler: three lanes of
        block_size slots (header incl. id+ref, FS/raw/SE, split-LSB)."""
        return 3 * self.block_size
