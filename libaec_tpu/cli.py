"""Command-line tool with the reference `aec` option surface
(/root/reference/src/aec.c:242-257):

    aec [-3] [-N] [-b size] [-d] [-j samples] [-m] [-n bits] [-p]
        [-r blocks] [-s] [-t] SOURCE DEST

Defaults match the reference: 8 bits/sample, block 8, rsi 2, preprocessing
on.  Large inputs encode and decode on the JAX device when it is an
accelerator; everything else runs the native codec.
"""
import sys

from .config import Config
from .constants import (
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from .decode import decode_buffer_status
from .encode import encode_buffer

_USAGE = """NAME
\taec - encode or decode files with Adaptive Entropy Coding

SYNOPSIS
\taec [OPTION]... SOURCE DEST

OPTIONS
\t-3\t\t24 bit samples are stored in 3 bytes
\t-N\t\tdisable pre/post processing
\t-b size\t\tinternal buffer size in bytes
\t-d\t\tdecode SOURCE. If -d is not used: encode.
\t-j samples\tblock size in samples
\t-m\t\tsamples are MSB first. Default is LSB
\t-n bits\t\tbits per sample
\t-p\t\tpad RSI to byte boundary
\t-r blocks\treference sample interval in blocks
\t-s\t\tsamples are signed. Default is unsigned
\t-t\t\tuse restricted set of code options
"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    bits_per_sample = 8
    block_size = 8
    rsi = 2
    flags = AEC_DATA_PREPROCESS
    dflag = False
    chunk = 10485760  # -b: internal buffer size (aec.c:149-156)

    def get_param(i):
        if len(argv[i]) == 2:
            return int(argv[i + 1]), i + 2
        return int(argv[i][2:]), i + 1

    i = 0
    try:
        while i < len(argv) - 2:
            opt = argv[i]
            if not opt.startswith("-"):
                raise ValueError(opt)
            c = opt[1]
            if c == "3":
                flags |= AEC_DATA_3BYTE
            elif c == "N":
                flags &= ~AEC_DATA_PREPROCESS
            elif c == "b":
                chunk, i = get_param(i)
                continue
            elif c == "d":
                dflag = True
            elif c == "j":
                block_size, i = get_param(i)
                continue
            elif c == "m":
                flags |= AEC_DATA_MSB
            elif c == "n":
                bits_per_sample, i = get_param(i)
                continue
            elif c == "p":
                flags |= AEC_PAD_RSI
            elif c == "r":
                rsi, i = get_param(i)
                continue
            elif c == "s":
                flags |= AEC_DATA_SIGNED
            elif c == "t":
                flags |= AEC_RESTRICTED
            else:
                raise ValueError(opt)
            i += 1
    except (ValueError, IndexError):
        sys.stderr.write(_USAGE)
        return 1

    if len(argv) - i < 2:
        sys.stderr.write(_USAGE)
        return 1
    infn, outfn = argv[i], argv[i + 1]

    try:
        cfg = Config(bits_per_sample, block_size, rsi, flags)
    except Exception as e:
        sys.stderr.write(f"ERROR: initialization failed ({e})\n")
        return 1

    with open(infn, "rb") as f:
        data = f.read()

    # -b sizes the internal buffer; the reference scales it by the sample
    # byte width (aec.c:149-156).  Host chunking here is whole RSIs, so the
    # scaled byte size maps onto rsis_per_chunk.
    if cfg.bits_per_sample > 16:
        chunk *= 3 if (cfg.bits_per_sample <= 24 and cfg.three_byte) else 4
    elif cfg.bits_per_sample > 8:
        chunk *= 2
    rsis_per_chunk = max(1, chunk // cfg.rsi_len_bytes)

    if dflag:
        return _decode_to_file(data, cfg, outfn,
                               rsis_per_chunk=rsis_per_chunk)
    else:
        out = encode_buffer(data, cfg, rsis_per_chunk=rsis_per_chunk)

    with open(outfn, "wb") as f:
        f.write(out)
    return 0


def _decode_to_file(data, cfg, outfn, rsis_per_chunk=None):
    """Stream-decode in bounded memory: complete RSIs are scanned and
    decoded in chunks written straight to the file; only the sub-RSI tail
    needs a one-RSI buffer.  CLI semantics stream until input is exhausted
    (aec.c:191-219), so no output-size bound is involved.

    Large streams route phase 2 to the device (decode.decode_buffer_tpu
    with a file part_sink) when JAX has an accelerator -- same policy as
    decode_buffer_status."""
    from . import native
    from .decode import _device_decode_wanted, decode_buffer_tpu

    # the compressed length is a conservative proxy for the decoded length
    # (lossless streams of this codec are rarely below ~0.5x)
    if native.get_lib() is not None and _device_decode_wanted(len(data)):
        # offsets-only pre-scan gives the exact complete-RSI count, so the
        # device decoder's output size is tight (+1 RSI for the partial
        # tail) instead of the worst-case bound; output bytes stream to
        # the file through part_sink, keeping memory chunk-bounded
        scanned = native.scan_rsis(data, 0, 1 << 40, cfg)
        if scanned is not None:
            n_rsis, _end = scanned
            tight = (n_rsis + 1) * cfg.rsi_len_bytes
            with open(outfn, "wb") as f:
                status, _ = decode_buffer_tpu(data, cfg, tight,
                                              part_sink=f.write)
            if status < 0:
                sys.stderr.write(f"ERROR: {status}\n")
                return 1
            return 0

    if native.get_lib() is None:
        # no toolchain: scalar fallback with the worst-case output bound
        bound = ((len(data) * 8 // (cfg.id_len + 2) + 2)
                 * 64 * cfg.block_size * cfg.bytes_per_sample)
        status, out = decode_buffer_status(data, cfg, bound)
        if status < 0:
            sys.stderr.write(f"ERROR: {status}\n")
            return 1
        with open(outfn, "wb") as f:
            f.write(out)
        return 0

    rsi_bytes = cfg.rsi_len_bytes
    if rsis_per_chunk is None:
        rsis_per_chunk = max(1, (64 << 20) // rsi_bytes)
    pos = 0
    status = 0
    with open(outfn, "wb") as f:
        while True:
            n, end = native.scan_rsis(data, pos, rsis_per_chunk, cfg)
            if n == 0:
                break
            status, out = native.decode(data, n * rsi_bytes, cfg,
                                        start_bit=pos)
            f.write(out)
            pos = end
            if status < 0:
                break
        if status == 0:
            # partial trailing RSI (or trailing padding bits)
            status, out = native.decode_tail(data, pos, rsi_bytes, cfg)
            f.write(out)
    if status < 0:
        sys.stderr.write(f"ERROR: {status}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
