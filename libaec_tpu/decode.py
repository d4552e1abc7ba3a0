"""Decoder orchestration.

Decode of an un-indexed AEC stream is inherently serial at the bit level
(option IDs are discovered only by decoding; SURVEY.md §2).  The design is
two-phase:

  phase 1 (host, native C++): sequential structural scan
          (native.scan_blocks) -- GB/s-class, lengths + per-block payload
          records only, no sample reconstruction;
  phase 2 (device): data-parallel entropy decode of every block payload
          (ops/bitunpack.py) + lane-parallel inverse predictor
          (ops/unpredict.py) + on-device byte layout.

The pure-CPU alternative (native.decode) runs phase 2 on worker threads
with the scalar core instead; a pure-numpy fallback keeps the package
functional without a C++ toolchain.
"""
import numpy as np

from . import native
from .config import Config
from .constants import (
    AEC_MEM_ERROR,
    AEC_OK,
    AecDataError,
    AecError,
    AecMemError,
)


# Streams whose decoded size reaches this run phase 2 on the device by
# default (when JAX has an accelerator); below it the native CPU decoder
# is as fast or faster.  Measured on an H100 (700 W) host, bench config,
# warm, median of 5 alternating rounds: at 256 MiB the two are within
# noise (device 643 vs native 647 MiB/s, 2 of 5 rounds); from 16 to 128
# MiB native won at least 3 of 5 rounds at every size.
DEVICE_DECODE_MIN_BYTES = 256 << 20


def _device_decode_wanted(out_size):
    """Routing policy for the one-shot decode surface.

    LIBAEC_TPU_DECODE=device forces the device path, =cpu forces the
    native/numpy path; default ("auto") picks the device for outputs of at
    least DEVICE_DECODE_MIN_BYTES when JAX's default device is an
    accelerator and the native library (the device path's phase-1 scan)
    is built.  A JAX that fails to start raises here."""
    import os

    mode = os.environ.get("LIBAEC_TPU_DECODE", "auto")
    if mode == "cpu":
        return False
    if mode == "device":
        return True
    if out_size < DEVICE_DECODE_MIN_BYTES or native.get_lib() is None:
        return False
    from .backend import on_accelerator

    return on_accelerator()


def _decode_cpu_status(data, cfg: Config, out_size):
    """CPU decode: native two-phase threaded decoder, numpy fallback."""
    res = native.decode(bytes(data), out_size, cfg)
    if res is not None:
        return res
    return decode_buffer_numpy(bytes(data), out_size, cfg)


def decode_buffer_status(data, cfg: Config, out_size):
    """One-shot decode with C-style (status, bytes) result
    (aec_buffer_decode parity, decode.c:843-854).

    Large streams route to the two-phase device decoder
    (decode_buffer_tpu) when JAX has an accelerator; the CPU path is the
    small-stream default (see _device_decode_wanted)."""
    if _device_decode_wanted(out_size):
        return decode_buffer_tpu(data, cfg, out_size)
    return _decode_cpu_status(data, cfg, out_size)


def decode_buffer(data, cfg: Config, out_size):
    """One-shot decode; raises AecError subclasses on failure."""
    status, out = decode_buffer_status(data, cfg, out_size)
    if status == AEC_OK:
        return out
    if status == AEC_MEM_ERROR:
        raise AecMemError("output size not a whole number of samples")
    raise AecDataError(f"status {status}")


_DEC_JIT_CACHE = {}


def _jax_decode_fn(cfg, n_rsi):
    """Build (and cache) the jitted chunk decoder for a static RSI count.

    Signature: (win u32 [n_rsi*rsi, Wf], fs_bit, lsb_rel, meta, ref_sample
    -- u32 [n_rsi*rsi]) -> u8 [n_rsi*S*bsz]."""
    key = (cfg, n_rsi)
    fn = _DEC_JIT_CACHE.get(key)
    if fn is None:
        import jax

        from .ops import bitunpack
        from .ops.unpredict import samples_to_bytes_device, unpredict_rsis

        S = cfg.samples_per_rsi

        # named scopes label the stages in profiler traces
        def run(win, fs_bit, lsb_rel, meta, ref_sample):
            with jax.named_scope("decode_parse"):
                deltas = bitunpack.decode_blocks(
                    cfg, win, fs_bit, lsb_rel, meta, ref_sample)
            with jax.named_scope("decode_unpredict"):
                samples = unpredict_rsis(cfg, deltas.reshape(n_rsi, S))
            with jax.named_scope("decode_layout"):
                return samples_to_bytes_device(cfg, samples.reshape(-1))

        fn = jax.jit(run)
        _DEC_JIT_CACHE[key] = fn
    return fn


def scan_record_arrays(recs):
    """Device input arrays from a native.scan_blocks record dict:
    (win, fs_bit, lsb_rel, meta, ref_sample)."""
    fs_off = recs["fs_off"]
    return (
        recs["win"],
        (fs_off & np.uint64(31)).astype(np.uint32),
        # LSB region offset relative to the payload start (zero-run
        # records carry fs_off == lsb_off == 0, so this stays 0)
        (recs["lsb_off"] - fs_off).astype(np.uint32),
        recs["meta"],
        recs["ref_sample"],
    )


# Per-chunk window-width buckets (words).  The worst-case conforming
# window (ops/bitunpack.window_words: bs*bps/32 + 2 = 34 for the bench
# config) covers an uncompressed payload, but typical data's largest
# payload is a split block of ~bs*(k+2) bits -- 4-8 words.  Sizing the
# windows from the chunk's ACTUAL max span cuts the fill memcpys, the
# H2D staging and the device parse's memory traffic by the same factor;
# bucketing keeps the set of compiled kernel shapes small.
WF_BUCKETS = (6, 10, 18)


def _bucket_wf(cfg, recs, tail_bit):
    """Smallest bucketed window width covering every payload span in the
    chunk (in words, incl. the <=31-bit in-word start offset).  The span
    bound is the distance between consecutive non-zero payload starts
    (which over-counts by the next block's header -- safe)."""
    from .ops import bitunpack

    wf_max = bitunpack.window_words(cfg)
    fs_off = recs["fs_off"]
    nz = fs_off[(recs["meta"] & np.uint32(3)) != 0]
    if len(nz) == 0:
        return min(WF_BUCKETS[0], wf_max)
    ends = np.append(nz[1:], np.uint64(tail_bit))
    span = int((ends - nz).max())
    need = (31 + span + 31) // 32 + 1
    for b in WF_BUCKETS:
        if need <= b <= wf_max:
            return b
    return wf_max


def scan_chunk_bucketed(data, ask, cfg, start_bit=0, arena=None,
                        win_pool=None, fill_threads=None):
    """One scan chunk with per-chunk window bucketing: records-only walk
    (wf=0), width bucketed from the actual max payload span, windows
    filled by the standalone threaded fill.  Returns (recs, cnt,
    tail_bit, wf_b) with recs["win"] sized [n, wf_b], or None without the
    native library.  win_pool (dict wf -> [buffers]) recycles fill
    buffers across chunks."""
    from .ops import bitunpack

    res = native.scan_blocks(data, ask, bitunpack.max_fs_bits(cfg), cfg,
                             wf=0, start_bit=start_bit, arena=arena)
    if res is None:
        return None
    recs, cnt, tail_bit = res
    wf_b = _bucket_wf(cfg, recs, tail_bit)
    buf = None
    if win_pool is not None and win_pool.get(wf_b):
        cand = win_pool[wf_b].pop()
        if cand.shape[0] >= max(len(recs["fs_off"]), 1):
            buf = cand
        else:  # too small for this chunk; keep it for a later short one
            win_pool[wf_b].insert(0, cand)
    win = native.fill_windows(data, recs["fs_off"], recs["meta"], wf_b,
                              threads=fill_threads, win=buf)
    recs = dict(recs)
    recs["win"] = win
    return recs, cnt, tail_bit, wf_b


def decode_buffer_tpu(data, cfg: Config, out_size, chunk_rsis=None,
                      part_sink=None):
    """Two-phase decode with the entropy phase on device (status, bytes).

    part_sink, if given, receives the decoded bytes incrementally (in
    order) instead of accumulating them -- the returned bytes are then
    empty.  This bounds host memory to one device chunk for
    file-streaming consumers (the CLI).

    Phase 1 (native.scan_blocks): structural scan -> per-block payload
    records.  Phase 2 (jax, ops/bitunpack.py): all block payloads decode in
    parallel (FS rank-select, LSB field gathers, SE unpairing, zero
    fills), then the lane-parallel inverse predictor (ops/unpredict.py)
    and the byte layout, all on device.  The serial core finishes any tail
    the scan could not validate, preserving the reference's
    truncation/error semantics (decode.c:818-825) bit-exactly.

    Phase 1 needs the native library: without it this raises
    RuntimeError rather than quietly decoding on the CPU.
    """
    _require_native()
    data = bytes(data)
    bsz = cfg.bytes_per_sample
    S = cfg.samples_per_rsi
    max_samples = out_size // bsz
    want_rsis = max_samples // S

    if chunk_rsis is None:
        # ~8M delta samples (32 MB u32) per device dispatch
        chunk_rsis = max(1, (8 << 20) // S)

    # The scan is resumable (start_bit), so it runs in device-chunk-sized
    # slices with the device dispatch issued between slices: jax dispatch
    # is asynchronous, so the device decodes chunk i while the host scans
    # chunk i+1.  This also bounds host record memory to one chunk.
    from concurrent.futures import ThreadPoolExecutor

    parts = []
    emit = part_sink if part_sink is not None else parts.append
    pending = []
    # Record-arena pool: a fresh np.empty per chunk costs ~6 ms of page
    # faults (comparable to the walk itself).  An arena is recycled only
    # once its chunk's OUTPUT has been fetched, which orders after the
    # input transfer that read it.  Window buffers recycle the same way,
    # pooled per bucketed width.
    free_arenas = []
    win_pool = {}
    # Output fetches run on ONE worker thread (FIFO keeps emit order):
    # D2H of chunk i overlaps the scan + dispatch of chunk i+1.
    fetch_pool = ThreadPoolExecutor(1)
    fetch_futs = []

    def fetch(dev_out, cnt, arena, wf_b, win_buf):
        by = np.asarray(dev_out).view(np.uint8)
        if arena is not None:
            free_arenas.append(arena)
        if win_buf is not None:
            win_pool.setdefault(wf_b, []).append(win_buf)
        emit(by[: cnt * S * bsz].tobytes())

    def drain_one():
        fetch_futs.append(fetch_pool.submit(fetch, *pending.pop(0)))
        if len(fetch_futs) >= 3:
            fetch_futs[-3].result()

    from .ops import bitunpack

    max_fs = bitunpack.max_fs_bits(cfg)

    # The window fill for chunk i runs on its own worker thread WHILE the
    # main thread walks chunk i+1 -- the walk is the serial chain, the
    # fill is memcpy work, so phase-1 throughput is max(walk, fill)
    # rather than their sum (chunk i's dispatch simply waits for its
    # fill before being issued).
    fill_pool = ThreadPoolExecutor(1)
    staged = None  # (fill_future, recs, cnt, arena, wf_b, win_buf)

    def fill_job(recs, tb):
        # bucket + fill off the serial walk chain: both depend only on
        # this chunk's records
        wf_b = _bucket_wf(cfg, recs, tb)
        buf = None
        if win_pool.get(wf_b):
            cand = win_pool[wf_b].pop()
            if cand.shape[0] >= max(len(recs["fs_off"]), 1):
                buf = cand
            else:
                win_pool[wf_b].insert(0, cand)
        win = native.fill_windows(data, recs["fs_off"], recs["meta"],
                                  wf_b, 1, buf)
        return wf_b, win

    def dispatch_staged():
        fut, recs, cnt, arena = staged
        wf_b, win = fut.result()
        recs["win"] = win
        win_buf = win.base if win.base is not None else win
        arrs = scan_record_arrays(recs)
        # bucket the chunk shape to a power of two to bound recompiles
        cpad = cnt if cnt == chunk_rsis else _next_pow2(cnt)
        nrec = cpad * cfg.rsi
        chunk_arrs = []
        for a in arrs:
            if len(a) < nrec:  # pad with zero-kind (all-zero) records
                pad_w = ((0, nrec - len(a)),) + ((0, 0),) * (a.ndim - 1)
                a = np.pad(a, pad_w)
            chunk_arrs.append(a)
        fn = _jax_decode_fn(cfg, cpad)
        pending.append((fn(*chunk_arrs), cnt, arena, wf_b, win_buf))
        if len(pending) > 4:  # bound device residency, keep 4 in flight
            drain_one()

    n_rsis = 0
    tail_bit = 0
    while n_rsis < want_rsis:
        ask = min(chunk_rsis, want_rsis - n_rsis)
        arena = free_arenas.pop() if free_arenas else native.ScanArena(
            chunk_rsis * cfg.rsi, 0)
        recs, cnt, tail_bit = native.scan_blocks(
            data, ask, max_fs, cfg, wf=0, start_bit=tail_bit, arena=arena)
        if cnt == 0:
            break
        recs = dict(recs)
        fut = fill_pool.submit(fill_job, recs, tail_bit)
        if staged is not None:
            dispatch_staged()
        staged = (fut, recs, cnt, arena)
        n_rsis += cnt
        if cnt < ask:  # truncated / malformed / oversized-FS tail
            break
    if staged is not None:
        dispatch_staged()
    fill_pool.shutdown()
    while pending:
        drain_one()
    for f in fetch_futs:
        f.result()
    fetch_pool.shutdown()

    done_bytes = n_rsis * S * bsz
    status, tail = native.decode_tail(data, tail_bit, out_size - done_bytes,
                                      cfg)
    if part_sink is not None:
        if tail:
            part_sink(tail)
        return status, b""
    return status, b"".join(parts) + tail


def _require_native():
    if native.get_lib() is None:
        raise RuntimeError(
            "device decode needs the native scan library, which failed to "
            "build or load")


def _next_pow2(n):
    return 1 << (n - 1).bit_length() if n > 1 else 1


def decode_buffers_tpu(datas, cfg: Config, out_sizes, scan_threads=None,
                       chunk_rsis=None):
    """Decode many independent AEC streams with scan/device overlap.

    The dominant production deployment (HDF5 chunks, SZIP scanlines) is
    many self-contained streams: the serial structural scan -- the
    whole-stream decode bottleneck -- parallelises
    embarrassingly ACROSS streams while the device decodes every stream's
    payloads.  Scans run on a host thread pool (the native call releases
    the GIL); the main thread drains scan results in stream order and
    issues the asynchronous device dispatches, so the chip stays busy
    while later streams are still being scanned.

    datas: sequence of byte buffers; out_sizes: per-stream decoded sizes.
    Returns a list of (status, bytes), each identical to
    decode_buffer_tpu(datas[i], cfg, out_sizes[i]).  Raises RuntimeError
    without the native library, as decode_buffer_tpu does.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    datas = [bytes(d) for d in datas]
    n = len(datas)
    if n == 0:
        return []
    _require_native()
    bsz = cfg.bytes_per_sample
    S = cfg.samples_per_rsi
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // S)

    def scan_stream(i):
        """Full chunked scan of stream i (worker thread, no jax calls).
        Returns (chunks, tail_bit, n_rsis): chunks = [(arrs, cnt), ...].
        Window widths are bucketed per chunk (streams are scanned on
        parallel workers already, so the fill runs single-threaded)."""
        data = datas[i]
        want = (out_sizes[i] // bsz) // S
        chunks = []
        n_rsis = 0
        tail_bit = 0
        while n_rsis < want:
            ask = min(chunk_rsis, want - n_rsis)
            recs, cnt, tail_bit, _wf = scan_chunk_bucketed(
                data, ask, cfg, start_bit=tail_bit, fill_threads=1)
            if cnt == 0:
                break
            chunks.append((scan_record_arrays(recs), cnt))
            n_rsis += cnt
            if cnt < ask:
                break
        return chunks, tail_bit, n_rsis

    if scan_threads is None:
        scan_threads = min(max(1, (os.cpu_count() or 2) - 1), 8, n)
    results = [None] * n

    def finish_stream(i, pending, tail_bit, n_rsis):
        """Fetch stream i's device outputs and decode its serial tail
        (runs on the single fetch worker, so streams finish in order
        while the main thread keeps dispatching later streams)."""
        parts = []
        for dev_out, cnt in pending:
            by = np.asarray(dev_out).view(np.uint8)
            parts.append(by[: cnt * S * bsz].tobytes())
        done = n_rsis * S * bsz
        status, tail = native.decode_tail(datas[i], tail_bit,
                                          out_sizes[i] - done, cfg)
        results[i] = (status, b"".join(parts) + tail)

    with ThreadPoolExecutor(scan_threads) as pool, \
            ThreadPoolExecutor(1) as fetcher:
        futures = [pool.submit(scan_stream, i) for i in range(n)]
        fetch_futs = []
        for i, fut in enumerate(futures):
            chunks, tail_bit, n_rsis = fut.result()
            pending = []
            for arrs, cnt in chunks:
                cpad = cnt if cnt == chunk_rsis else _next_pow2(cnt)
                nrec = cpad * cfg.rsi
                chunk_arrs = []
                for a in arrs:
                    if len(a) < nrec:
                        pad_w = ((0, nrec - len(a)),) + \
                            ((0, 0),) * (a.ndim - 1)
                        a = np.pad(a, pad_w)
                    chunk_arrs.append(a)
                fn = _jax_decode_fn(cfg, cpad)
                pending.append((fn(*chunk_arrs), cnt))
            fetch_futs.append(
                fetcher.submit(finish_stream, i, pending, tail_bit,
                               n_rsis))
            if len(fetch_futs) >= 4:  # bound in-flight device outputs
                fetch_futs[-4].result()
        for f in fetch_futs:
            f.result()
    return results


# ---------------------------------------------------------------------------
# numpy fallback decoder (used only when the native library cannot build)
# ---------------------------------------------------------------------------

def _se_unpair(m):
    i = int((np.sqrt(8.0 * m + 1.0) - 1.0) / 2.0)
    while (i + 1) * (i + 2) // 2 <= m:
        i += 1
    while i * (i + 1) // 2 > m:
        i -= 1
    b = m - i * (i + 1) // 2
    return i - b, b


class _Bits:
    def __init__(self, data):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def has(self, n):
        return self.pos + n <= len(self.bits)

    def get(self, n):
        v = 0
        b = self.bits[self.pos : self.pos + n]
        for bit in b:
            v = (v << 1) | int(bit)
        self.pos += n
        return v

    def get_fs(self):
        idx = np.argmax(self.bits[self.pos :])  # first 1
        if not len(self.bits[self.pos :]) or self.bits[self.pos + idx] == 0:
            self.pos = len(self.bits)
            return None
        self.pos += idx + 1
        return int(idx)


def decode_buffer_numpy(data, out_size, cfg: Config):
    """Reference-exact scalar decode in python/numpy (slow fallback)."""
    bs = cfg.block_size
    S = cfg.samples_per_rsi
    bsz = cfg.bytes_per_sample
    id_len = cfg.id_len
    bps = cfg.bits_per_sample
    uncomp_id = (1 << id_len) - 1
    pp = cfg.preprocess

    bits = _Bits(data)
    rsibuf = np.zeros(S, np.uint64)
    out = bytearray()
    rsip = 0
    flush_start = 0
    max_samples = out_size // bsz
    samples_put = 0
    status = AEC_OK
    last_out = 0

    def flush():
        nonlocal flush_start, rsip, last_out
        n = rsip - flush_start
        if n > 0:
            vals = rsibuf[flush_start:rsip].astype(np.uint32)
            if pp:
                vals, last_out = _unpredict(vals, flush_start == 0, last_out,
                                            cfg)
            for v in vals:
                out.extend(_put_bytes(int(v), bsz, cfg.msb))
            flush_start = rsip
        if rsip == S:
            rsip = 0
            flush_start = 0

    def put(v):
        nonlocal rsip, samples_put
        rsibuf[rsip] = v
        rsip += 1
        samples_put += 1
        if rsip == S:
            flush()

    def room():
        return samples_put < max_samples

    running = True
    while running:
        ref = False
        if rsip == 0:
            if cfg.pad_rsi:
                bits.pos = (bits.pos + 7) & ~7
            ref = pp
        if not bits.has(id_len):
            break
        cid = bits.get(id_len)
        if cid == 0:
            if not bits.has(1):
                break
            sub = bits.get(1)
            if ref:
                if not bits.has(bps) or not room():
                    break
                put(bits.get(bps))
            if sub == 1:  # second extension
                i = 1 if ref else 0
                while i < bs:
                    m = bits.get_fs()
                    if m is None:
                        running = False
                        break
                    va, vb = _se_unpair(m)
                    if (i & 1) == 0:
                        if not room() or rsip >= S:
                            running = False
                            status = status if room() else status
                            break
                        put(va)
                        i += 1
                    if not room() or rsip >= S:
                        running = False
                        break
                    put(vb)
                    i += 1
            else:  # zero run
                fs = bits.get_fs()
                if fs is None:
                    break
                zb = fs + 1
                if zb == 5:
                    b = rsip // bs
                    zb = min(cfg.rsi - b, 64 - (b % 64))
                elif zb > 5:
                    zb -= 1
                n = zb * bs - (1 if ref else 0)
                if S - rsip < n:
                    status = -3
                    break
                for _ in range(n):
                    if not room():
                        running = False
                        break
                    put(0)
        elif cid == uncomp_id:
            for _ in range(bs):
                if not bits.has(bps) or not room() or rsip >= S:
                    running = False
                    break
                put(bits.get(bps))
        else:
            k = cid - 1
            if ref:
                if not bits.has(bps) or not room():
                    break
                put(bits.get(bps))
            n = bs - (1 if ref else 0)
            if S - rsip < n:
                status = -3
                break
            fsv = []
            for _ in range(n):
                f = bits.get_fs()
                if f is None:
                    running = False
                    break
                fsv.append(f << k)
            if len(fsv) < n:
                break
            for i in range(n):
                if not bits.has(k) or not room():
                    running = False
                    break
                put(fsv[i] | (bits.get(k) if k else 0))

    if status == AEC_OK:
        left = out_size - bsz * samples_put
        if 0 < left < bsz:
            status = AEC_MEM_ERROR
    if status == AEC_OK:
        flush()
    return status, bytes(out)


def _put_bytes(v, bsz, msb):
    if msb:
        return bytes((v >> (8 * (bsz - 1 - i))) & 0xFF for i in range(bsz))
    return bytes((v >> (8 * i)) & 0xFF for i in range(bsz))


def _unpredict(deltas, first_of_rsi, last_out, cfg: Config):
    """Inverse predictor (decode.c FLUSH macro), scalar numpy."""
    xmax = cfg.xmax
    unsigned_path = cfg.xmin == 0
    vals = deltas.astype(np.int64)
    out = np.zeros_like(vals)
    i = 0
    data = last_out
    if first_of_rsi and len(vals):
        r = int(vals[0])
        if cfg.signed:
            m = 1 << (cfg.bits_per_sample - 1)
            r = (r ^ m) - m
        data = r
        out[0] = r
        i = 1
    if unsigned_path:
        med = xmax // 2 + 1
        for j in range(i, len(vals)):
            d = int(vals[j])
            half = (d >> 1) + (d & 1)
            zig = (d >> 1) if (d & 1) == 0 else -((d >> 1) + 1)
            mask = xmax if (data & med) else 0
            if half <= (mask ^ (data & 0xFFFFFFFF)):
                data = (data + zig) & 0xFFFFFFFF
            else:
                data = mask ^ d
            out[j] = data
    else:
        sxmax = np.int64(np.uint32(xmax).astype(np.int32))
        for j in range(i, len(vals)):
            d = int(vals[j])
            half = (d >> 1) + (d & 1)
            zig = (d >> 1) if (d & 1) == 0 else -((d >> 1) + 1)
            if data < 0:
                if half <= sxmax + data + 1:
                    data = data + zig
                else:
                    data = d - sxmax - 1
            else:
                if half <= sxmax - data:
                    data = data + zig
                else:
                    data = sxmax - d
            out[j] = data
    return out.astype(np.uint32), data
