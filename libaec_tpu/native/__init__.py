"""Native host runtime: builds and loads the C++ decoder/scanner.

The shared library is compiled on first use (g++ is part of the toolchain);
the build is cached next to the source.  All entry points have numpy
fallbacks elsewhere so import never hard-fails.
"""
import ctypes
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "aectpu_native.cpp", _HERE / "encoder.cpp",
         _HERE / "libaec_abi.cpp"]
_SO = _HERE / "libaectpu.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build():
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", str(_SO), *map(str, _SRCS),
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if not _SO.exists() or _SO.stat().st_mtime < max(
                    s.stat().st_mtime for s in _SRCS):
                _build()
            lib = ctypes.CDLL(str(_SO))
            lib.aectpu_encode.restype = ctypes.c_int
            lib.aectpu_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,      # in
                ctypes.c_void_p, ctypes.c_size_t,      # out
                ctypes.POINTER(ctypes.c_size_t),       # out_written
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ]
            lib.aectpu_decode.restype = ctypes.c_int
            lib.aectpu_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,      # in
                ctypes.c_void_p, ctypes.c_size_t,      # out
                ctypes.POINTER(ctypes.c_size_t),       # out_written
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ]
            lib.aectpu_decode_parallel.restype = ctypes.c_int
            lib.aectpu_decode_parallel.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,  # in
                ctypes.c_void_p, ctypes.c_size_t,                   # out
                ctypes.POINTER(ctypes.c_size_t),                    # written
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                ctypes.c_int,                                       # threads
            ]
            lib.aectpu_scan_rsis.restype = ctypes.c_int
            lib.aectpu_scan_rsis.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ]
            lib.aectpu_decode_deltas.restype = ctypes.c_int
            lib.aectpu_decode_deltas.argtypes = lib.aectpu_decode.argtypes
            lib.aectpu_decode_tail.restype = ctypes.c_int
            lib.aectpu_decode_tail.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            ]
            lib.aectpu_encode_parallel.restype = ctypes.c_int
            lib.aectpu_encode_parallel.argtypes = \
                lib.aectpu_encode.argtypes + [ctypes.c_int]  # threads
            lib.aectpu_fill_windows.restype = ctypes.c_int
            lib.aectpu_fill_windows.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,      # in
                ctypes.c_void_p, ctypes.c_void_p,      # fs_off, meta
                ctypes.c_void_p, ctypes.c_int,         # win, wf
                ctypes.c_size_t, ctypes.c_int,         # n, threads
            ]
            lib.aectpu_scan_blocks.restype = ctypes.c_int
            lib.aectpu_scan_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,      # in
                ctypes.c_uint64,                       # start_bit
                ctypes.c_size_t, ctypes.c_int,         # max_rsis, max_fs_bits
                ctypes.c_void_p, ctypes.c_void_p,      # fs_off, lsb_off
                ctypes.c_void_p, ctypes.c_void_p,      # meta, ref_sample
                ctypes.c_void_p, ctypes.c_int,         # win, wf
                ctypes.POINTER(ctypes.c_size_t),       # n_rsis_out
                ctypes.POINTER(ctypes.c_uint64),       # tail_bit_out
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                ctypes.c_int,                          # n_threads
            ]
            _lib = lib
        except Exception:
            _build_failed = True
            return None
    return _lib


def encode(data, cfg, out_cap=None, threads=None):
    """Native one-shot encode.  Returns (status, bytes) or None if the
    library is unavailable.  With out_cap given, status is
    AEC_STREAM_ERROR when the stream exceeds it and the bytes are the
    first out_cap (aec_buffer_encode capacity semantics).

    threads > 1 routes to aectpu_encode_parallel (serial decision pass +
    worker emit + parallel stitch, bit-identical by construction);
    threads=None picks it automatically for multi-MiB buffers."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    if threads is None:
        threads = min(os.cpu_count() or 1, 8) \
            if len(data) >= (4 << 20) else 1

    # worst case mirrors encode.worst_case_bits_per_block: id + reference
    # sample + max(uncompressed payload, one 64-bit zero-run FS) per block,
    # plus per-RSI byte pads and the final flush
    bsz = cfg.bytes_per_sample
    n_samples = len(data) // bsz
    nb = -(-max(n_samples, 1) // cfg.block_size)
    per_block = cfg.id_len + 1 + cfg.bits_per_sample + max(
        cfg.block_size * cfg.bits_per_sample, 64)
    worst = (nb * per_block) // 8 + nb // max(cfg.rsi, 1) + 16
    cap = worst if out_cap is None else out_cap
    out = np.empty(max(cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    if threads > 1:
        status = lib.aectpu_encode_parallel(
            inview.ctypes.data_as(ctypes.c_void_p), len(data),
            out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(written),
            cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
            threads,
        )
    else:
        status = lib.aectpu_encode(
            inview.ctypes.data_as(ctypes.c_void_p), len(data),
            out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(written),
            cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
        )
    n = min(written.value, cap)
    return status, out[:n].tobytes()


def decode(data: bytes, out_cap: int, cfg, threads=None, start_bit=0):
    """Native decode from an RSI-start bit offset. Returns (status, bytes).

    Large buffers use the two-phase parallel path (structural scan + per-RSI
    worker threads, bit-identical to the scalar core by construction)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    out = np.empty(max(out_cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    # zero-copy view of the input (bytes/bytearray/memoryview/ndarray)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    in_ptr = inview.ctypes.data_as(ctypes.c_void_p)
    out_ptr = out.ctypes.data_as(ctypes.c_void_p)
    if threads is None:
        # 2x oversubscription overlaps the sequential structural scan with
        # payload workers (the scan thread spends its tail joining the
        # pool); never spawn more workers than there are RSIs to decode
        rsi_bytes = cfg.samples_per_rsi * cfg.bytes_per_sample
        n_rsis = max(1, out_cap // rsi_bytes)
        threads = min(2 * (os.cpu_count() or 1), n_rsis) \
            if len(data) >= (1 << 20) else 1
    if threads > 1:
        status = lib.aectpu_decode_parallel(
            in_ptr, len(data), start_bit, out_ptr, out_cap,
            ctypes.byref(written),
            cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
            threads,
        )
    elif start_bit:
        status = lib.aectpu_decode_tail(
            in_ptr, len(data), start_bit, out_ptr, out_cap,
            ctypes.byref(written),
            cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
        )
    else:
        status = lib.aectpu_decode(
            in_ptr, len(data), out_ptr, out_cap, ctypes.byref(written),
            cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
        )
    return status, out[: written.value].tobytes()


def scan_rsis(data, start_bit: int, max_rsis: int, cfg):
    """Offsets-only scan: (n complete RSIs from start_bit, end_bit), or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n_rsis = ctypes.c_size_t(0)
    end_bit = ctypes.c_uint64(0)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    status = lib.aectpu_scan_rsis(
        inview.ctypes.data_as(ctypes.c_void_p), len(data), start_bit,
        max_rsis, ctypes.byref(n_rsis), ctypes.byref(end_bit),
        cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
    )
    if status != 0:
        return None
    return n_rsis.value, end_bit.value


class ScanArena:
    """Reusable record buffers for scan_blocks.

    A fresh np.empty per scan chunk costs ~6 ms of page faults per 32 MiB
    chunk (the OS returns large frees to the kernel) -- nearly the cost of
    the structural walk itself.  Callers that scan in a loop keep a small
    pool of arenas and recycle one only after the device has consumed the
    chunk built in it (decode.py ties recycling to draining the chunk's
    OUTPUT, which orders after the input transfer)."""

    def __init__(self, nrec, wf):
        import numpy as np

        self.nrec = nrec
        self.wf = wf
        self.fs_off = np.empty(nrec, np.uint64)
        self.lsb_off = np.empty(nrec, np.uint64)
        self.meta = np.empty(nrec, np.uint32)
        self.ref_sample = np.empty(nrec, np.uint32)
        self.win = np.empty((nrec, wf), np.uint32) if wf else None

    def fits(self, nrec, wf):
        return nrec <= self.nrec and wf == self.wf


def fill_windows(data, fs_off, meta, wf, threads=None, win=None):
    """Materialise [n, wf] payload windows for records from a wf=0 scan.

    Decouples the window width from the walk: decode.py runs the scan
    records-only, buckets wf from the chunk's ACTUAL max payload span
    (typically 3-4x smaller than the worst-case conforming window), then
    fills here on worker threads.  Returns the win array (the passed-in
    `win` buffer when given, for arena reuse), or None without the native
    library."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = len(fs_off)
    if win is None:
        win = np.empty((max(n, 1), wf), np.uint32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    lib.aectpu_fill_windows(
        inview.ctypes.data_as(ctypes.c_void_p), len(data),
        fs_off.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p),
        win.ctypes.data_as(ctypes.c_void_p), wf, n, threads,
    )
    return win[:n]


def scan_blocks(data, max_rsis: int, max_fs_bits: int, cfg, wf=0,
                threads=None, start_bit=0, arena=None):
    """Phase-1 structural scan for the device decoder.

    Walks the stream from start_bit (an RSI boundary; 0 for the head) and
    emits one payload record per output block for every complete RSI whose
    FS regions fit the device kernel's static window -- once (popcount-bulk
    FS skipping, no sample reconstruction).  With wf > 0 it also
    materialises each block's wf-word payload window ("win", u32 [n, wf])
    so the device never gathers from the raw stream; the window memcpys
    run on `threads-1` worker threads chasing the scan (the walk itself is
    inherently serial).  Resumability (start_bit = previous tail_bit) lets
    decode_buffer_tpu overlap scan chunks with in-flight device decodes.

    Returns (records dict of numpy arrays sized n_rsis*rsi, n_rsis,
    tail_bit) or None if the native library is unavailable.  The serial
    tail (truncated / malformed / oversized-FS input) resumes at tail_bit.
    """
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    if threads is None:
        threads = min(os.cpu_count() or 1, 8) \
            if wf and len(data) >= (1 << 20) else 1
    nrec = max(max_rsis * cfg.rsi, 1)
    if arena is not None and arena.fits(nrec, wf):
        fs_off, lsb_off = arena.fs_off, arena.lsb_off
        meta, ref_sample, win = arena.meta, arena.ref_sample, arena.win
    else:
        fs_off = np.empty(nrec, np.uint64)
        lsb_off = np.empty(nrec, np.uint64)
        meta = np.empty(nrec, np.uint32)
        ref_sample = np.empty(nrec, np.uint32)
        win = np.empty((nrec, wf), np.uint32) if wf else None
    n_rsis = ctypes.c_size_t(0)
    tail_bit = ctypes.c_uint64(0)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    status = lib.aectpu_scan_blocks(
        inview.ctypes.data_as(ctypes.c_void_p), len(data), start_bit,
        max_rsis, max_fs_bits,
        fs_off.ctypes.data_as(ctypes.c_void_p),
        lsb_off.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p),
        ref_sample.ctypes.data_as(ctypes.c_void_p),
        win.ctypes.data_as(ctypes.c_void_p) if wf else None, wf,
        ctypes.byref(n_rsis), ctypes.byref(tail_bit),
        cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
        threads,
    )
    if status != 0:
        return None
    n = n_rsis.value * cfg.rsi
    recs = {
        "fs_off": fs_off[:n],
        "lsb_off": lsb_off[:n],
        "meta": meta[:n],
        "ref_sample": ref_sample[:n],
    }
    if wf:
        recs["win"] = win[:n]
    return recs, n_rsis.value, tail_bit.value


def decode_tail(data, start_bit: int, out_cap: int, cfg):
    """Serial decode resuming at an RSI-start bit offset (status, bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    out = np.empty(max(out_cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    status = lib.aectpu_decode_tail(
        inview.ctypes.data_as(ctypes.c_void_p), len(data), start_bit,
        out.ctypes.data_as(ctypes.c_void_p), out_cap, ctypes.byref(written),
        cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
    )
    return status, out[: written.value].tobytes()


def decode_deltas(data: bytes, max_samples: int, cfg):
    """Phase-1 decode: bitstream -> raw mapped deltas (u32 [n]), inverse
    predictor NOT applied.  Feeds the device payload decoder (decode.py).
    Returns (status, np.uint32 array) or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    out = np.empty(max(max_samples, 1), np.uint32)
    written = ctypes.c_size_t(0)
    inview = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    status = lib.aectpu_decode_deltas(
        inview.ctypes.data_as(ctypes.c_void_p), len(data),
        out.ctypes.data_as(ctypes.c_void_p), 4 * max_samples,
        ctypes.byref(written),
        cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags,
    )
    return status, out[: written.value // 4]
