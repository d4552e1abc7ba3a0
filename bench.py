"""Benchmark: encode/decode throughput on the reference's own `make bench`
workload.

Methodology mirrors /root/reference/src/benc.sh + bdec.sh: decode
data/typical.rz (ECHAM 16-bit MSB climate field), replicate to a large
buffer, code with bits_per_sample=16, block_size=64, rsi=256, preprocessing
on, and report MiB/s.  Baselines (BASELINE.md, reference C build, one x86
core): encode 317 MiB/s, decode 202 MiB/s.

Reported numbers (all in the ONE JSON line):
  value / encode_kernel   device-side sustained encode: chunks resident on
                          device, k/bit carries chained as device scalars
                          inside one jitted fori_loop (see _loop_time).
  encode_e2e              encode_buffer() wall time including input staging
                          and compressed-byte materialisation.
  decode_device           device-side sustained decode (phase-2 kernels;
                          records staged once, pipelined dispatch).
  decode_scan             host phase-1 structural scan incl. payload-window
                          materialisation (arena-pooled, as production).
  decode_stream           pipelined single-stream decode: fresh host scans
                          overlapped with device decode iterations
                          (max(phase1, phase2) sustained; staging excluded
                          like decode_device).
  decode_e2e              decode_buffer_tpu() wall time including the scan,
                          record staging and output fetch.
  decode_cpu              the pure-CPU two-phase threaded decoder.
  encode_cpu              the native scalar encoder (C-ABI/small-buffer
                          path), bit-exactness asserted vs the device
                          stream.

Bit-exactness is asserted against the oracle-validated numpy encoder
before any timing.
"""
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from libaec_tpu import Config  # noqa: E402
from libaec_tpu import native  # noqa: E402
from libaec_tpu.constants import AEC_DATA_MSB, AEC_DATA_PREPROCESS  # noqa: E402

BASELINE_MIBS = 317.0         # reference C encode, measured in BASELINE.md
DECODE_BASELINE_MIBS = 202.0  # reference C decode, measured in BASELINE.md
FLAGS = AEC_DATA_MSB | AEC_DATA_PREPROCESS
CFG = Config(16, 64, 256, FLAGS)
RSI_SAMPLES = CFG.samples_per_rsi  # 16384 samples = 32 KiB
CHUNK_RSIS = 512                   # 16 MiB input per device call


def load_typical():
    rz = (REPO.parent / "reference" / "data" / "typical.rz")
    if not rz.exists():
        rz = REPO / ".refbuild" / "typical.rz"
    data = rz.read_bytes()
    status, out = native.decode(data, 1 << 20, CFG)
    assert status == 0 and len(out) == 1 << 20, "typical.rz decode failed"
    return out


def _loop_time(make_loop, n):
    """Per-iteration device time of a jitted n-iteration loop: best of
    three warm runs, each ending in block_until_ready."""
    import jax

    loop = make_loop(n)
    jax.block_until_ready(loop())  # compile + warm
    best = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop())
        best = min(best, time.perf_counter() - t0)
    return best / n


def bench_encode_kernel(chunk_u32, n_chunks, expect):
    """Device-sustained encode (MiB/s, one chunk's bytes): the chunk fn
    runs inside one jitted fori_loop threading the real inter-chunk
    carries (k, bit cursor mod 8; encode.c:369 semantics), so the number
    is pure back-to-back device throughput."""
    import jax
    import jax.numpy as jnp

    from libaec_tpu.encode import _jax_chunk_fn, words_to_stream_bytes

    fn = _jax_chunk_fn(CFG, CHUNK_RSIS, CFG.rsi)
    xd = jax.device_put(chunk_u32)
    words, total_bits, _ = fn(xd, 0, 0)  # warm-up / compile
    tb0 = int(total_bits)
    got = words_to_stream_bytes(words, tb0).tobytes()
    assert got == expect, "device chunk output mismatch"

    def make_loop(n):
        @jax.jit
        def loop():
            def body(i, carry):
                k, b0, acc = carry
                words, total_bits, k = fn(xd, k, b0)
                # consume the outputs so no iteration is dead code
                return (k, total_bits % jnp.uint32(8),
                        acc + total_bits + words[-1])

            return jax.lax.fori_loop(
                0, n, body,
                (jnp.int32(0), jnp.uint32(0), jnp.uint32(0)))[2]

        return loop

    per_chunk = _loop_time(make_loop, n_chunks)
    chunk_bytes = chunk_u32.size * 2
    return chunk_bytes / (1 << 20) / per_chunk, got


def bench_encode_e2e(raw):
    """Warm encode_buffer() wall time, plus a per-chunk breakdown of where
    the time goes (stage = H2D of the raw chunk bytes, dispatch = device
    compute + scalar sync, fetch = D2H of the compressed slice).  The
    warm-up call runs the FULL buffer so every chunk shape the timed run
    uses is compiled outside the timed region (a warm-up with another
    chunking would leave a compile inside the measurement)."""
    import jax

    from libaec_tpu.backend import jax_backend
    from libaec_tpu.encode import (_jax_chunk_fn_bytes, encode_buffer,
                                   words_to_stream_bytes)

    B = jax_backend()
    encode_buffer(raw, CFG, backend=B)  # compile + warm all chunk shapes
    t0 = time.time()
    comp = encode_buffer(raw, CFG, backend=B)
    dt = time.time() - t0

    # breakdown probe on one chunk of the same shape the e2e path used
    rpc = min(max(1, (64 << 20) // (RSI_SAMPLES * 4)),
              len(raw) // CFG.rsi_len_bytes)
    chunk = np.frombuffer(raw[: rpc * CFG.rsi_len_bytes], dtype=np.uint8)
    fn = _jax_chunk_fn_bytes(CFG, rpc, CFG.rsi)
    int(fn(chunk, 0, 0)[1])  # warm (no-op if e2e warmed it)
    t0 = time.time()
    xd = jax.block_until_ready(jax.device_put(chunk))
    t_stage = time.time() - t0
    t0 = time.time()
    words, tb, _ = fn(xd, 0, 0)
    tbv = int(tb)
    t_disp = time.time() - t0
    t0 = time.time()
    words_to_stream_bytes(words, tbv)
    t_fetch = time.time() - t0
    breakdown = {
        "chunk_mib": round(len(chunk) / (1 << 20), 1),
        "stage_s": round(t_stage, 3),
        "dispatch_s": round(t_disp, 3),
        "fetch_s": round(t_fetch, 3),
    }
    return len(raw) / (1 << 20) / dt, comp, breakdown


def bench_decode_device(comp, raw):
    """Phase-2 device-sustained throughput (records staged once, the
    decode fn looped inside one jit) plus the host scan's throughput and
    the PIPELINED single-stream rate (host scan and device decode running
    concurrently, the production decode_buffer_tpu overlap)."""
    import jax
    import jax.numpy as jnp

    from libaec_tpu.decode import (_jax_decode_fn, scan_chunk_bucketed,
                                   scan_record_arrays)
    from libaec_tpu.ops import bitunpack

    n_rsis = len(raw) // CFG.rsi_len_bytes
    # production phase 1, exactly as decode_buffer_tpu runs it: a
    # records-only walk on the main thread with the previous pass's
    # bucketed window fill overlapped on a worker (phase-1 sustained =
    # max(walk, fill), which is what the pipeline actually achieves)
    from concurrent.futures import ThreadPoolExecutor

    from libaec_tpu.decode import _bucket_wf

    max_fs = bitunpack.max_fs_bits(CFG)
    arena2 = [native.ScanArena(n_rsis * CFG.rsi, 0) for _ in range(2)]
    wpool = {}
    fillex = ThreadPoolExecutor(1)

    def fill_one(recs, tb):
        # bucket + fill together, off the serial walk chain (mirrors
        # decode_buffer_tpu's fill_job)
        wb = _bucket_wf(CFG, recs, tb)
        buf = wpool[wb].pop() if wpool.get(wb) else None
        win = native.fill_windows(comp, recs["fs_off"], recs["meta"], wb,
                                  threads=1, win=buf)
        wpool.setdefault(wb, []).append(
            win.base if win.base is not None else win)

    def phase1_passes(n):
        t0 = time.time()
        prev = None
        for i in range(n):
            recs, n_ok, tail2 = native.scan_blocks(
                comp, n_rsis, max_fs, CFG, wf=0, arena=arena2[i % 2])
            assert n_ok == n_rsis
            if prev is not None:
                prev.result()
            prev = fillex.submit(fill_one, dict(recs), tail2)
        prev.result()
        return time.time() - t0

    phase1_passes(1)  # warm (allocations, page faults)
    t_scan = float("inf")
    for _rep in range(3):
        # 4 passes per rep: the first walk of a rep has no fill to
        # overlap, so longer runs approach the steady-state rate
        t_scan = min(t_scan, phase1_passes(4) / 4)

    recs, n_ok, _tail, wf_b = scan_chunk_bucketed(comp, n_rsis, CFG)
    assert n_ok == n_rsis
    arrs = [jax.device_put(a) for a in scan_record_arrays(recs)]
    fn = _jax_decode_fn(CFG, n_rsis)
    out = fn(*arrs)
    got = np.asarray(out).view(np.uint8)[: len(raw)].tobytes()
    assert got == raw, "device decode mismatch"

    def make_loop(n):
        @jax.jit
        def loop():
            def body(i, acc):
                o = fn(*arrs).ravel()
                return acc + o[0] + o[-1]

            return jax.lax.fori_loop(0, n, body, jnp.uint32(0))

        return loop

    per_iter = _loop_time(make_loop, 8)
    mib = len(raw) / (1 << 20)

    # Pipelined single-stream rate: while the device runs n decode
    # iterations (async dispatch), the host runs n FULL fresh phase-1
    # passes exactly as decode_buffer_tpu does -- the records walk on the
    # main thread OVERLAPPED with the previous iteration's bucketed
    # window fill on a worker (phase-1 = max(walk, fill), not their
    # sum).  The per-iteration time is max(phase1, device), i.e. the
    # sustained rate of the two-phase pipeline on one stream; staging is
    # excluded as in decode_device.
    def pipelined(n, loop):
        t0 = time.time()
        res = loop()  # async device dispatch of n decode iterations
        prev = None
        for i in range(n):
            recs, _n, tail2 = native.scan_blocks(
                comp, n_rsis, max_fs, CFG, wf=0, arena=arena2[i % 2])
            if prev is not None:
                prev.result()
            prev = fillex.submit(fill_one, dict(recs), tail2)
        if prev is not None:
            prev.result()
        jax.block_until_ready(res)
        return time.time() - t0

    loop_n = make_loop(8)
    jax.block_until_ready(loop_n())
    per_pipe = min(pipelined(8, loop_n) for _rep in range(3)) / 8
    return mib / per_iter, mib / t_scan, mib / per_pipe


def bench_decode_scan_pad(raw):
    """Host structural-scan rate over an AEC_PAD_RSI stream of the same
    data (byte-aligned RSI starts, decode.c:406-409).  Recorded so the
    PAD path's phase-1 cost is visible next to the plain stream's: the
    padding realignment is one masked seek per RSI, so the two should
    track each other.  (A speculative parallel scan exploiting the byte
    alignment was analysed and rejected -- Rice streams have no markers
    to validate a mid-stream guess against; docs/DESIGN.md §3.)"""
    from libaec_tpu.constants import AEC_PAD_RSI
    from libaec_tpu.ops import bitunpack

    from concurrent.futures import ThreadPoolExecutor

    from libaec_tpu.decode import _bucket_wf

    cfg_pad = Config(CFG.bits_per_sample, CFG.block_size, CFG.rsi,
                     CFG.flags | AEC_PAD_RSI)
    st, comp_pad = native.encode(raw, cfg_pad)
    assert st == 0
    st, back = native.decode(comp_pad, len(raw), cfg_pad)
    assert st == 0 and back == raw, "PAD_RSI round trip failed"
    n_rsis = len(raw) // cfg_pad.rsi_len_bytes
    max_fs = bitunpack.max_fs_bits(cfg_pad)
    arenas = [native.ScanArena(n_rsis * cfg_pad.rsi, 0) for _ in range(2)]
    wpool = {}
    fillex = ThreadPoolExecutor(1)

    def fill_one(recs, tb):
        wb = _bucket_wf(cfg_pad, recs, tb)
        buf = wpool[wb].pop() if wpool.get(wb) else None
        win = native.fill_windows(comp_pad, recs["fs_off"], recs["meta"],
                                  wb, threads=1, win=buf)
        wpool.setdefault(wb, []).append(
            win.base if win.base is not None else win)

    def passes(n):
        t0 = time.time()
        prev = None
        for i in range(n):
            recs, n_ok, tail2 = native.scan_blocks(
                comp_pad, n_rsis, max_fs, cfg_pad, wf=0,
                arena=arenas[i % 2])
            assert n_ok == n_rsis
            if prev is not None:
                prev.result()
            prev = fillex.submit(fill_one, dict(recs), tail2)
        prev.result()
        return time.time() - t0

    passes(1)  # warm
    t_scan = float("inf")
    for _rep in range(3):
        t_scan = min(t_scan, passes(4) / 4)
    return len(raw) / (1 << 20) / t_scan


def bench_cpu_paired(raw, comp):
    """Interleaved same-run CPU timings: our native encode (1 thread and
    parallel), our native decode, and the reference C library
    (.refbuild/src/libaec.so, the oracle build) over the same buffers.
    Each rep measures all five back to back, so thermal/contention drift
    moves every number together and best-of-rep ratios are meaningful
    from the recorded JSON alone.  Also asserts the reference produces
    OUR bytes (and decodes them back), a free oracle check.  Returns
    (enc_cpu, enc_cpu_mt, dec_cpu, ref_enc, ref_dec); the ref_* entries
    are None when the oracle build is absent."""
    import ctypes

    mib = len(raw) / (1 << 20)
    so = REPO / ".refbuild" / "src" / "libaec.so"
    lib = ctypes.CDLL(str(so)) if so.exists() else None

    class S(ctypes.Structure):
        _fields_ = [
            ("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
            ("total_in", ctypes.c_size_t), ("next_out", ctypes.c_void_p),
            ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_size_t),
            ("bits_per_sample", ctypes.c_uint), ("block_size", ctypes.c_uint),
            ("rsi", ctypes.c_uint), ("flags", ctypes.c_uint),
            ("state", ctypes.c_void_p),
        ]

    inb = ctypes.create_string_buffer(raw, len(raw))
    outb = ctypes.create_string_buffer(len(raw) + (1 << 20))
    compb = ctypes.create_string_buffer(comp, len(comp))
    decb = ctypes.create_string_buffer(len(raw))

    def ref_encode():
        s = S(next_in=ctypes.cast(inb, ctypes.c_void_p),
              avail_in=len(raw),
              next_out=ctypes.cast(outb, ctypes.c_void_p),
              avail_out=len(outb.raw), bits_per_sample=CFG.bits_per_sample,
              block_size=CFG.block_size, rsi=CFG.rsi, flags=CFG.flags)
        assert lib.aec_buffer_encode(ctypes.byref(s)) == 0
        return s.total_out

    def ref_decode():
        s = S(next_in=ctypes.cast(compb, ctypes.c_void_p),
              avail_in=len(comp),
              next_out=ctypes.cast(decb, ctypes.c_void_p),
              avail_out=len(raw), bits_per_sample=CFG.bits_per_sample,
              block_size=CFG.block_size, rsi=CFG.rsi, flags=CFG.flags)
        assert lib.aec_buffer_decode(ctypes.byref(s)) == 0

    best = [float("inf")] * 5
    tout = 0
    for _rep in range(5):
        t0 = time.time()
        st, ncomp = native.encode(raw, CFG, threads=1)
        best[0] = min(best[0], time.time() - t0)
        assert st == 0 and ncomp == comp, "native encode verify failed"
        t0 = time.time()
        st, ncomp = native.encode(raw, CFG)
        best[1] = min(best[1], time.time() - t0)
        assert st == 0 and ncomp == comp, "native parallel encode differs"
        t0 = time.time()
        st, out = native.decode(comp, len(raw), CFG)
        best[2] = min(best[2], time.time() - t0)
        assert st == 0 and out == raw, "cpu decode verify failed"
        if lib is not None:
            t0 = time.time()
            tout = ref_encode()
            best[3] = min(best[3], time.time() - t0)
            t0 = time.time()
            ref_decode()
            best[4] = min(best[4], time.time() - t0)
    if lib is not None:
        assert outb.raw[:tout] == comp, "reference encode differs from ours"
        assert decb.raw[: len(raw)] == raw, "reference decode verify failed"
    return tuple(
        (mib / b if b != float("inf") else None) for b in best)


def main():
    total_mib = int(os.environ.get("LIBAEC_BENCH_MB", "256"))
    typical = load_typical()

    chunk_bytes = CHUNK_RSIS * RSI_SAMPLES * 2
    reps = chunk_bytes // len(typical)
    chunk_raw = typical * reps
    chunk_u32 = np.frombuffer(chunk_raw, dtype=">u2").astype(np.uint32) \
        .reshape(CHUNK_RSIS, RSI_SAMPLES)
    n_chunks = max(1, (total_mib << 20) // chunk_bytes)

    # correctness anchor: the numpy-backend encoder is oracle-validated
    from libaec_tpu.encode import encode_buffer

    expect = encode_buffer(chunk_raw, CFG)

    enc_kernel, comp = bench_encode_kernel(chunk_u32, n_chunks, expect)

    e2e_mib = min(total_mib, 64) << 20
    e2e_raw = (typical * (e2e_mib // len(typical)))[:e2e_mib]
    enc_e2e, _, e2e_breakdown = bench_encode_e2e(e2e_raw)

    dec_device, dec_scan, dec_stream = bench_decode_device(comp, chunk_raw)

    from libaec_tpu.decode import decode_buffer_tpu

    t0 = time.time()
    st, out = decode_buffer_tpu(comp, CFG, len(chunk_raw))
    dec_e2e = len(chunk_raw) / (1 << 20) / (time.time() - t0)
    assert st == 0 and out == chunk_raw, "decode_buffer_tpu verify failed"

    dec_scan_pad = bench_decode_scan_pad(chunk_raw)

    # interleaved paired CPU timings: ours (1-thread / parallel / decode)
    # and the reference library measured back to back each rep
    enc_cpu, enc_cpu_mt, dec_cpu, ref_enc, ref_dec = bench_cpu_paired(
        chunk_raw, comp)

    result = {
        "metric": "encode_throughput",
        "value": round(enc_kernel, 1),
        "unit": "MiB/s",
        "vs_baseline": round(enc_kernel / BASELINE_MIBS, 3),
        "encode_e2e": round(enc_e2e, 1),
        "encode_e2e_breakdown": e2e_breakdown,
        "decode_device": round(dec_device, 1),
        "decode_device_vs_baseline": round(
            dec_device / DECODE_BASELINE_MIBS, 3),
        "decode_scan": round(dec_scan, 1),
        "decode_scan_pad": round(dec_scan_pad, 1),
        "decode_stream": round(dec_stream, 1),
        "decode_e2e": round(dec_e2e, 1),
        "decode_cpu": round(dec_cpu, 1),
        "encode_cpu": round(enc_cpu, 1),
        "encode_cpu_mt": round(enc_cpu_mt, 1),
        # same-run reference-library timings (paired measurement: machine
        # drift moves these with the repo numbers above)
        "ref_encode_cpu": round(ref_enc, 1) if ref_enc else None,
        "ref_decode_cpu": round(ref_dec, 1) if ref_dec else None,
    }
    print(json.dumps(result))
    ratio = len(comp) / len(chunk_raw)
    print(f"# kernel encode over {n_chunks * chunk_bytes >> 20} MiB, "
          f"ratio {ratio:.4f}; e2e over {e2e_mib >> 20} MiB",
          file=sys.stderr)


if __name__ == "__main__":
    main()
