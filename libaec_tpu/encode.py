"""Encoder orchestration: array in -> CCSDS 121.0-B-2 bitstream out.

Pipeline (all stages data-parallel over blocks; see ops/ for the per-stage
array reformulations of the reference's FSM encoder, encode.c:467-754):

  bytes -> u32 samples -> Δ-preprocess -> zero-run segmentation
        -> vectorised k-search (+ associative warm-start chain)
        -> option selection -> field expansion -> parallel bit pack

Host-side state carried between chunks: the running split position k
(reference: state->k, encode.c:369/407), the bit cursor modulo 8 and the
shared boundary byte.  Chunks are always whole numbers of RSIs, which the
format guarantees to be safe cut points (predictor and zero-run state never
cross an RSI; encode.c:252-254, 649-655).
"""
import numpy as np

from . import backend as _backend
from . import native as _native
from .config import Config
from .ops import accessors, bitpack, fields, options, preprocess, zeroruns


def pipeline_fields(B, cfg, x, nb, k_init):
    """Shared encode pipeline: samples -> flat bit fields.

    x: u32 [n_rsi, nb*bs] samples (tail RSI already padded to whole blocks);
    nb: blocks per RSI (== cfg.rsi except for a short trailing RSI);
    k_init: incoming warm-start k (int or traced scalar).

    Returns (widths u32 [N], values u32 [N], k_final i32 scalar).
    """
    xp = B.xp
    u32 = xp.uint32
    bs = cfg.block_size
    n_rsi = x.shape[0]
    NB = n_rsi * nb
    # ingest masking for callers handing raw u32 arrays (Config.mask);
    # byte-level entries arrive pre-masked, where this fuses to nothing
    if cfg.bits_per_sample < 32:
        x = x & u32(cfg.mask)

    if cfg.preprocess:
        d, ref_samples = preprocess.delta_map(xp, x, cfg)
    else:
        d, ref_samples = x, xp.zeros(n_rsi, dtype=u32)

    d_blk = d.reshape(NB, bs)
    b_in_rsi = xp.broadcast_to(
        xp.arange(nb, dtype=xp.int32)[None, :], (n_rsi, nb))

    # block metadata
    ref = (b_in_rsi == 0).reshape(NB) if cfg.preprocess else xp.zeros(
        NB, dtype=bool)
    refu = ref.astype(u32)
    this_bs = u32(bs) - refu
    ub = (u32(bs) - refu) * u32(cfg.bits_per_sample)  # uncomp_len per block
    ref_sample_blk = xp.broadcast_to(ref_samples[:, None], (n_rsi, nb)).reshape(NB)

    # zero blocks and run segmentation
    z2 = (d_blk == 0).all(axis=-1).reshape(n_rsi, nb)
    zinfo = zeroruns.zero_run_info(B, z2, nb, cfg.preprocess)
    is_zero = z2.reshape(NB)
    zero_emit = zinfo["emit"].reshape(NB)
    zero_fsval = zinfo["fsval"].reshape(NB)
    zero_ref = zinfo["zero_ref"].reshape(NB)

    # k-search
    if cfg.id_len > 1:
        Fhi, Flo = options.fs_tables(xp, d_blk)
        Lhi, Llo = options.split_len_pairs(xp, Fhi, Flo, this_bs)
        searched = ~is_zero
        maps = options.k_walk_maps(B, Fhi, Flo, Lhi, Llo, this_bs,
                                   cfg.kmax, searched)
        k_in, k_final = options.chain_k(B, maps, k_init)
        chosen_k = xp.take_along_axis(maps, k_in[:, None], axis=1)[:, 0]
        lhi = xp.take_along_axis(Lhi, chosen_k[:, None], axis=1)[:, 0]
        llo = xp.take_along_axis(Llo, chosen_k[:, None], axis=1)[:, 0]
        # uint32 truncation of the 64-bit length, as encode.c:409
        split32 = (lhi << u32(16)) + llo
    else:
        chosen_k = xp.zeros(NB, dtype=xp.int32)
        k_final = xp.zeros((), dtype=xp.int32)
        split32 = xp.full(NB, u32(options.U32_MAX))

    se_len, _ = options.se_lengths(xp, d_blk, ub)
    opt = options.select_option(xp, split32, se_len, ub, cfg.id_len)

    w, v = fields.gen_fields(xp, cfg, d_blk, opt, chosen_k, ref,
                             ref_sample_blk, is_zero, zero_emit,
                             zero_fsval, zero_ref)
    if cfg.pad_rsi:
        # AEC_PAD_RSI: zero-pad each RSI's bitstream to a byte boundary
        # (encode.c:499-505 under ENABLE_RSI_PADDING).  Every block gets one
        # extra field slot, zero-width except on the RSI's last block, where
        # it absorbs (-rsi_bits) % 8 zero bits.  Because every previous RSI
        # ends aligned, the pad is a per-RSI-local computation.
        slots = w.shape[1]
        wR = w.reshape(n_rsi, nb, slots)
        pad_bits = (-wR.sum(axis=(1, 2), dtype=u32)) % u32(8)
        last = (xp.arange(nb) == nb - 1)[None, :, None]
        extra_w = xp.where(last, pad_bits[:, None, None],
                           u32(0)).astype(u32)
        extra_w = xp.broadcast_to(extra_w, (n_rsi, nb, 1))
        w = xp.concatenate([wR, extra_w], axis=2).reshape(NB, slots + 1)
        v = xp.concatenate(
            [v.reshape(n_rsi, nb, slots),
             xp.zeros((n_rsi, nb, 1), u32)], axis=2).reshape(NB, slots + 1)
    return w.reshape(-1), v.reshape(-1), k_final


def worst_case_bits_per_block(cfg):
    """Upper bound on one block's emitted CDS bits: id + reference sample +
    the larger of the uncompressed payload and a zero-run FS field.  A zero
    run emitted mid-segment can span 63 blocks (fsval 63 -> 64-bit unary
    field, encode.c:574-579), which exceeds block_size*bps for small
    blocks/narrow samples."""
    return cfg.id_len + 1 + cfg.bits_per_sample + max(
        cfg.block_size * cfg.bits_per_sample, 64)


def encode_blocks_core(B, cfg, x, nb, k_init, bit0):
    """numpy-path chunk encode: returns (packed u8 bytes, total_bits,
    k_final int)."""
    w, v, k_final = pipeline_fields(B, cfg, x, nb, k_init)
    packed, total_bits = bitpack.pack_fields(B, w, v, bit0)
    return packed, total_bits, int(k_final)


_JIT_CACHE = {}


def _jax_chunk_fn(cfg, n_rsi, nb):
    """Build (and cache) the jitted chunk encoder for a static shape.

    Signature: (x u32 [n_rsi, nb*bs], k_init i32, bit0 u32) ->
               (words u32 [nwords], total_bits u32, k_final i32)."""
    key = (cfg, n_rsi, nb)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import jax

        B = _backend.jax_backend()
        NB = n_rsi * nb
        worst = worst_case_bits_per_block(cfg)
        local_words = (worst + 31) // 32 + 1
        group = 64
        gw1 = group * (local_words + 1) + 1
        nwords = (NB * worst + 8) // 32 + gw1 + 2

        def swap32(w):
            # big-endian materialisation on device, fused into the packer's
            # last pass, so the host slices bytes without a byteswap pass
            u32 = jax.numpy.uint32
            return ((w << u32(24)) | ((w & u32(0xFF00)) << u32(8))
                    | ((w >> u32(8)) & u32(0xFF00)) | (w >> u32(24)))

        # named scopes label the stages in profiler traces
        def chunk(x, k_init, bit0):
            with jax.named_scope("encode_fields"):
                w, v, k_final = pipeline_fields(B, cfg, x, nb, k_init)
            with jax.named_scope("encode_pack"):
                words, total_bits = bitpack.pack_fields_grouped(
                    B, w.reshape(NB, -1), v.reshape(NB, -1), bit0,
                    local_words, nwords, group)
                return swap32(words), total_bits, k_final

        fn = _coerce_carries(jax.jit(chunk))
        _JIT_CACHE[key] = fn
    return fn


def _coerce_carries(fn):
    """Normalise the (k_init, bit0) carry avals before the jit boundary.

    Callers pass either Python ints (weakly-typed) or device scalars
    (strong int32/uint32); without coercion those are DIFFERENT jit cache
    keys and the chunk program compiles twice -- the second compile
    landing inside whatever loop first mixes the two.  Coercing to strong dtypes here collapses them to one
    program; jnp.asarray is a no-op on already-typed values and safe
    under an outer trace."""
    import functools

    import jax.numpy as jnp

    @functools.wraps(fn)
    def call(x, k_init, bit0):
        return fn(x, jnp.asarray(k_init, jnp.int32),
                  jnp.asarray(bit0, jnp.uint32))

    return call


def _jax_chunk_fn_bytes(cfg, n_rsi, nb):
    """Chunk encoder taking RAW stream bytes: the byte->u32 sample widening
    (ops/accessors.bytes_to_samples) runs on device, so the host stages
    bytes_per_sample bytes per sample instead of 4 -- for the 16-bit bench
    config that halves H2D traffic, and the host-side numpy conversion
    pass disappears.  Signature: (raw u8 [n_rsi*S*bsz], k_init, bit0)."""
    key = ("bytes", cfg, n_rsi, nb)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        inner = _jax_chunk_fn(cfg, n_rsi, nb)
        bsz = cfg.bytes_per_sample
        ns = n_rsi * nb * cfg.block_size

        def chunk_bytes(raw_u8, k_init, bit0):
            with jax.named_scope("encode_widen"):
                x = accessors.bytes_to_samples(jnp, raw_u8, bsz, cfg.msb,
                                               cfg.mask)
            return inner(x.reshape(n_rsi, ns // n_rsi), k_init, bit0)

        fn = _coerce_carries(jax.jit(chunk_bytes))
        _JIT_CACHE[key] = fn
    return fn


def words_to_stream_bytes(words, total_bits):
    """Slice the stream bytes for `total_bits` of payload out of a chunk
    fn's word buffer (index 0 = front pad word).  The device already
    emitted the words big-endian (swap32 in _jax_chunk_fn), so this is a
    zero-copy reinterpret + slice.  The word buffer is sized for the
    worst case (~uncompressed length); slicing BEFORE np.asarray fetches
    only the compressed bytes over the host link instead of the whole
    buffer."""
    nbytes = (total_bits + 7) // 8
    nwords = (4 + nbytes + 3) // 4
    by = np.asarray(words[:nwords]).view(np.uint8)
    return by[4:4 + nbytes]


def encode_blocks_jax(cfg, x_np, nb, k_init, bit0):
    """Device-path chunk encode; host slices the packed bytes."""
    fn = _jax_chunk_fn(cfg, x_np.shape[0], nb)
    words, total_bits, k_final = fn(x_np, k_init, bit0)
    total_bits = int(total_bits)
    return words_to_stream_bytes(words, total_bits), total_bits, int(k_final)


def encode_chunks_jax_pipelined(cfg, chunks, on_chunk, k0=0, bit0=0,
                                max_inflight=4, raw_bytes=False):
    """Dispatch whole-RSI chunks back-to-back with bounded device residency.

    chunks: iterable of u32 [n_rsi, samples_per_rsi] arrays (or, with
    raw_bytes=True, u8 [n_rsi * rsi_len_bytes] stream-byte arrays widened
    on device; equal n_rsi gets one compiled program).  The inter-chunk
    carries -- warm-start k (encode.c:369) and the bit cursor modulo 8 --
    stay on the device as traced scalars, so the device never waits on the
    host between chunks; up to `max_inflight` chunks are queued before the
    oldest result is materialised through
    `on_chunk(words_dev, total_bits_dev)` (bounding device memory, unlike
    an unbounded dispatch of every chunk).

    Returns the final k as a device scalar.
    """
    import jax.numpy as jnp

    k = jnp.int32(k0)
    bits_in_byte = jnp.uint32(bit0)
    rsi_bytes = cfg.rsi_len_bytes
    pending = []
    for x in chunks:
        if raw_bytes:
            fn = _jax_chunk_fn_bytes(cfg, x.shape[0] // rsi_bytes, cfg.rsi)
        else:
            fn = _jax_chunk_fn(cfg, x.shape[0], cfg.rsi)
        words, total_bits, k = fn(x, k, bits_in_byte)
        # next chunk's leading partial byte: cursor mod 8
        bits_in_byte = total_bits % jnp.uint32(8)
        pending.append((words, total_bits))
        if len(pending) >= max_inflight:
            on_chunk(*pending.pop(0))
    for w, tb in pending:
        on_chunk(w, tb)
    return k


# Buffers at least this large default to the device encode pipeline when
# JAX has an accelerator; below it the native encoder is as fast or
# faster.  Measured on an H100 (700 W) host, bench config, warm, median of
# 5 alternating rounds: the device never won every round at any size; at
# 256 MiB it was at par (1055 vs native 1016 MiB/s, 4 of 5 rounds), at
# 128 MiB it lost (860 vs 962 MiB/s, 0 of 5).
AUTO_JAX_MIN_BYTES = 256 << 20


def _auto_backend(n_bytes):
    """Array backend for the python encode paths: the jax pipeline for
    large buffers (or LIBAEC_TPU_ENCODE=jax), numpy otherwise."""
    import os

    mode = os.environ.get("LIBAEC_TPU_ENCODE", "auto")
    if mode == "numpy":
        return _backend.NUMPY
    if mode != "jax" and n_bytes < AUTO_JAX_MIN_BYTES:
        return _backend.NUMPY
    return _backend.jax_backend()


def _native_encode_wanted(n_bytes):
    """Whether the default route should use the native scalar encoder:
    below the device threshold, and for large buffers when JAX has no
    accelerator.  LIBAEC_TPU_ENCODE=numpy/jax opt out; =native forces it."""
    import os

    mode = os.environ.get("LIBAEC_TPU_ENCODE", "auto")
    if mode == "native":
        return True
    if mode != "auto":
        return False
    return n_bytes < AUTO_JAX_MIN_BYTES or not _backend.on_accelerator()


class _OutputAssembler:
    """Accumulates chunk outputs, OR-merging the shared boundary byte."""

    def __init__(self):
        self.buf = bytearray()
        self.bits = 0

    def append(self, chunk_bytes, total_bits):
        chunk = np.asarray(chunk_bytes)
        bit0 = self.bits % 8
        if bit0 and len(self.buf):
            self.buf[-1] |= int(chunk[0])
            self.buf += chunk[1:].tobytes()
        else:
            self.buf += chunk.tobytes()
        self.bits += total_bits - bit0

    def finish(self):
        if self.bits == 0:
            # empty input: the reference still flushes one zero byte
            # (encode.c:686-695, observed behaviour)
            return b"\x00"
        return bytes(self.buf)


def encode_buffer(data, cfg: Config, backend=None, rsis_per_chunk=None,
                  out_size=None):
    """One-shot encode of a byte buffer (aec_buffer_encode parity).

    Trailing bytes that do not make up a whole sample are ignored, and a
    trailing partial RSI is padded by repeating the last sample
    (encode.c:676-685).

    out_size, if given, is the caller's output capacity: when the encoded
    stream does not fit, AecStreamError is raised -- the condition
    aec_buffer_encode reports as AEC_STREAM_ERROR when the final flush
    cannot complete into next_out/avail_out (libaec.h:154-166,
    encode.c:938-963).

    With backend=None, buffers of at least AUTO_JAX_MIN_BYTES route to
    the device pipeline when JAX has an accelerator (LIBAEC_TPU_ENCODE=
    numpy disables this; =jax forces it; =native forces the scalar C++
    encoder); everything else uses the native scalar encoder (bit-exact
    vs the numpy oracle by test), with numpy as the no-toolchain
    fallback."""
    if backend is None and _native_encode_wanted(len(data)):
        res = _native.encode(bytes(data), cfg)
        if res is not None:
            status, comp = res
            if status == 0:
                if out_size is not None and len(comp) > out_size:
                    from .constants import AecStreamError

                    raise AecStreamError(
                        f"encoded stream ({len(comp)} bytes) exceeds the "
                        f"output capacity ({out_size} bytes)")
                return comp
        # no native library (or unexpected status): python paths below
    B = backend or _auto_backend(len(data))
    bsz = cfg.bytes_per_sample
    n_samples = len(data) // bsz
    out = _OutputAssembler()
    if n_samples == 0:
        return out.finish()

    raw = np.frombuffer(bytes(data[: n_samples * bsz]), dtype=np.uint8)

    S = cfg.samples_per_rsi
    n_full = n_samples // S
    rem = n_samples - n_full * S
    use_jax = B.name == "jax"
    if rsis_per_chunk is None:
        # jax amortises dispatch over big chunks; the numpy path's all-k
        # tables and field grids want to stay cache-resident (64 MiB
        # chunks measured 6x SLOWER than 1 MiB on the fallback)
        budget = (64 << 20) if use_jax else (1 << 20)
        rsis_per_chunk = max(1, budget // (S * 4))

    def run_chunk(x_np, nb):
        bit0 = out.bits % 8
        return encode_blocks_core(B, cfg, x_np, nb, run_chunk.k, bit0)

    run_chunk.k = 0
    if use_jax and n_full:
        # pipelined device path: full-RSI chunks of RAW stream bytes
        # dispatched without host syncs (k and the bit cursor carried as
        # device scalars); the byte->sample widening runs on device, so
        # staging moves bsz bytes per sample instead of 4.  Compressed
        # bytes are fetched on ONE worker thread (FIFO, so assembly order
        # is preserved) overlapping D2H with the next chunk's staging and
        # compute.
        from concurrent.futures import ThreadPoolExecutor

        def gen_chunks():
            for s in range(0, n_full, rsis_per_chunk):
                cnt = min(rsis_per_chunk, n_full - s)
                yield raw[s * S * bsz:(s + cnt) * S * bsz]

        def materialise(words, total_bits):
            tb = int(total_bits)
            out.append(words_to_stream_bytes(words, tb), tb)

        with ThreadPoolExecutor(1) as ex:
            futs = []

            def on_chunk(words, total_bits):
                futs.append(ex.submit(materialise, words, total_bits))
                if len(futs) >= 5:  # bound device-buffer residency
                    futs[-5].result()

            k_dev = encode_chunks_jax_pipelined(cfg, gen_chunks(), on_chunk,
                                                raw_bytes=True)
            for f in futs:
                f.result()
        run_chunk.k = int(k_dev)
    elif n_full:
        samples = accessors.bytes_to_samples(
            np, raw[: n_full * S * bsz], bsz, cfg.msb, cfg.mask)
        for start in range(0, n_full, rsis_per_chunk):
            cnt = min(rsis_per_chunk, n_full - start)
            x = samples[start * S:(start + cnt) * S].reshape(cnt, S)
            packed, bits, run_chunk.k = run_chunk(x, cfg.rsi)
            out.append(packed, bits)
    if rem:
        nb_tail = -(-rem // cfg.block_size)
        tail = accessors.bytes_to_samples(
            np, raw[n_full * S * bsz:], bsz, cfg.msb, cfg.mask)
        pad = nb_tail * cfg.block_size - rem
        if pad:
            tail = np.concatenate([tail, np.full(pad, tail[-1], np.uint32)])
        # the sub-RSI tail is tiny: route it to numpy rather than paying a
        # jit specialisation on its odd shape
        packed, bits, run_chunk.k = encode_blocks_core(
            _backend.NUMPY, cfg, tail.reshape(1, nb_tail * cfg.block_size),
            nb_tail, run_chunk.k, out.bits % 8)
        out.append(packed, bits)
    result = out.finish()
    if out_size is not None and len(result) > out_size:
        from .constants import AecStreamError

        raise AecStreamError(
            f"encoded stream ({len(result)} bytes) exceeds the output "
            f"capacity ({out_size} bytes)")
    return result


def encode_buffer_status(data, cfg: Config, out_size, backend=None,
                         rsis_per_chunk=None):
    """C-style one-shot encode: (status, bytes) with caller-owned output
    capacity, mirroring aec_buffer_encode's next_out/avail_out contract
    (libaec.h:154-166).  On overflow the first out_size encoded bytes are
    returned with AEC_STREAM_ERROR, matching the reference's behaviour of
    filling the caller's buffer before aec_encode_end reports the
    incomplete flush (encode.c:929-948)."""
    from .constants import AEC_OK, AEC_STREAM_ERROR

    result = encode_buffer(data, cfg, backend=backend,
                           rsis_per_chunk=rsis_per_chunk)
    if len(result) > out_size:
        return AEC_STREAM_ERROR, result[:out_size]
    return AEC_OK, result
