"""ctypes wrapper around the reference libaec build, used as a bit-exactness oracle.

The reference C library (/root/reference, built out-of-source into
/root/repo/.refbuild) is the ground truth for golden tests: we encode/decode
random inputs with it and assert our codec produces identical bytes.

Reference API: /root/reference/src/libaec.h:67-166.
"""
import ctypes
import os
from pathlib import Path

_REF_BUILD = Path(__file__).resolve().parent.parent / ".refbuild" / "src"
# Separate reference build with -DENABLE_RSI_PADDING: the encode side of
# AEC_PAD_RSI (encode.c:499-505) is compiled out of the default build.
_REF_BUILD_PAD = (Path(__file__).resolve().parent.parent
                  / ".refbuild-pad" / "src")


class _AecStream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.POINTER(ctypes.c_ubyte)),
        ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_size_t),
        ("next_out", ctypes.POINTER(ctypes.c_ubyte)),
        ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_size_t),
        ("bits_per_sample", ctypes.c_uint),
        ("block_size", ctypes.c_uint),
        ("rsi", ctypes.c_uint),
        ("flags", ctypes.c_uint),
        ("state", ctypes.c_void_p),
    ]


class _SZcom(ctypes.Structure):
    _fields_ = [
        ("options_mask", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("pixels_per_block", ctypes.c_int),
        ("pixels_per_scanline", ctypes.c_int),
    ]


_lib = None
_szlib = None
_padlib = None


def _build_ref(build_dir, extra_cflags=None):
    """Build /root/reference out-of-source into build_dir (a test fixture,
    not a repo artifact). Returns True iff libaec.so exists afterwards."""
    if (build_dir / "src" / "libaec.so").exists():
        return True
    ref = Path("/root/reference")
    if not ref.exists():
        return False
    import subprocess

    args = ["cmake", "-S", str(ref), "-B", str(build_dir),
            "-DCMAKE_BUILD_TYPE=Release", "-G", "Ninja"]
    if extra_cflags:
        args.append(f"-DCMAKE_C_FLAGS={extra_cflags}")
    try:
        subprocess.run(args, check=True, capture_output=True, timeout=300)
        subprocess.run(["ninja", "-C", str(build_dir)],
                       check=True, capture_output=True, timeout=300)
    except Exception:
        return False
    return (build_dir / "src" / "libaec.so").exists()


def available():
    return _build_ref(_REF_BUILD.parent)


def pad_available():
    """The encode side of AEC_PAD_RSI (encode.c:499-505) is compiled out of
    the default build, so the padded oracle needs its own build tree."""
    return _build_ref(_REF_BUILD_PAD.parent, "-DENABLE_RSI_PADDING")


def _get_lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_REF_BUILD / "libaec.so"))
    return _lib


def _get_padlib():
    global _padlib
    if _padlib is None:
        _padlib = ctypes.CDLL(str(_REF_BUILD_PAD / "libaec.so"))
    return _padlib


def _get_szlib():
    global _szlib
    if _szlib is None:
        _szlib = ctypes.CDLL(str(_REF_BUILD / "libsz.so"))
    return _szlib


def _mkstream(data, out_size, bits_per_sample, block_size, rsi, flags):
    strm = _AecStream()
    inbuf = (ctypes.c_ubyte * max(len(data), 1)).from_buffer_copy(
        data if data else b"\0")
    outbuf = (ctypes.c_ubyte * max(out_size, 1))()
    strm.next_in = ctypes.cast(inbuf, ctypes.POINTER(ctypes.c_ubyte))
    strm.avail_in = len(data)
    strm.next_out = ctypes.cast(outbuf, ctypes.POINTER(ctypes.c_ubyte))
    strm.avail_out = out_size
    strm.bits_per_sample = bits_per_sample
    strm.block_size = block_size
    strm.rsi = rsi
    strm.flags = flags
    return strm, inbuf, outbuf


def encode(data, bits_per_sample, block_size, rsi, flags, out_size=None,
           padded_build=False):
    """One-shot aec_buffer_encode. Returns (status, bytes)."""
    lib = _get_padlib() if padded_build else _get_lib()
    if out_size is None:
        out_size = 2 * len(data) + 1024
    strm, inbuf, outbuf = _mkstream(
        data, out_size, bits_per_sample, block_size, rsi, flags)
    status = lib.aec_buffer_encode(ctypes.byref(strm))
    return status, bytes(outbuf[: strm.total_out])


def decode(data, bits_per_sample, block_size, rsi, flags, out_size):
    """One-shot aec_buffer_decode with exactly out_size avail_out."""
    lib = _get_lib()
    strm, inbuf, outbuf = _mkstream(
        data, out_size, bits_per_sample, block_size, rsi, flags)
    status = lib.aec_buffer_decode(ctypes.byref(strm))
    return status, bytes(outbuf[: strm.total_out])


def sz_compress(data, options_mask, bits_per_pixel, pixels_per_block,
                pixels_per_scanline, out_size=None):
    lib = _get_szlib()
    if out_size is None:
        out_size = 2 * len(data) + 1024
    param = _SZcom(options_mask, bits_per_pixel, pixels_per_block,
                   pixels_per_scanline)
    src = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
    dest = (ctypes.c_ubyte * out_size)()
    dlen = ctypes.c_size_t(out_size)
    status = lib.SZ_BufftoBuffCompress(
        dest, ctypes.byref(dlen), src, len(data), ctypes.byref(param))
    return status, bytes(dest[: dlen.value])


def sz_decompress(data, options_mask, bits_per_pixel, pixels_per_block,
                  pixels_per_scanline, out_size):
    lib = _get_szlib()
    param = _SZcom(options_mask, bits_per_pixel, pixels_per_block,
                   pixels_per_scanline)
    src = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
    dest = (ctypes.c_ubyte * out_size)()
    dlen = ctypes.c_size_t(out_size)
    status = lib.SZ_BufftoBuffDecompress(
        dest, ctypes.byref(dlen), src, len(data), ctypes.byref(param))
    return status, bytes(dest[: dlen.value])
