"""Streaming (zlib-style) API with aec_stream parity.

The reference implements byte-dribble streaming with a resumable FSM
(reference encode.c:467-707, decode.c:342-460).  This design
keeps suspend/resume at the host framing layer instead: input is buffered to
whole RSIs (the format's safe cut points), coded in data-parallel batches,
and the produced bytes are dribbled out through avail_out.  Byte output is
identical to the reference for any chunking of input/output.

API mirrors libaec.h:154-166:

    s = AecStream(bits_per_sample=16, block_size=64, rsi=256,
                  flags=AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    aec_encode_init(s); s.next_in = ...; aec_encode(s, AEC_FLUSH); ...

next_in/next_out are bytes-like/bytearray buffers indexed by the stream's
internal cursors; avail_in/avail_out/total_in/total_out match the C fields.
"""
import numpy as np

from . import backend as _backend
from . import native
from .config import Config
from .constants import (
    AEC_FLUSH,
    AEC_OK,
    AEC_STREAM_ERROR,
    AecStreamError,
)
from .encode import encode_blocks_core, encode_blocks_jax


class AecStream:
    """Mutable stream object mirroring struct aec_stream (libaec.h:67-97)."""

    def __init__(self, bits_per_sample=8, block_size=8, rsi=2, flags=0,
                 backend=None):
        self.bits_per_sample = bits_per_sample
        self.block_size = block_size
        self.rsi = rsi
        self.flags = flags
        self.next_in = b""
        self.avail_in = None  # None -> len(next_in)
        self.next_out = None  # bytearray to write into; None -> internal
        self.avail_out = None
        self.total_in = 0
        self.total_out = 0
        self._backend = backend
        self._state = None

    # internal ------------------------------------------------------------
    def _cfg(self):
        return Config(self.bits_per_sample, self.block_size, self.rsi,
                      self.flags)


class _EncState:
    def __init__(self, cfg, backend):
        self.cfg = cfg
        self.backend = backend or _backend.NUMPY
        self.inbuf = bytearray()   # buffered input not yet coded
        self.outbuf = bytearray()  # coded bytes not yet handed out
        self.bits = 0              # total bits coded so far
        self.k = 0                 # warm-start k carry
        self.flushed = False
        self.seen_input = False

    def _run(self, samples_u32, nb):
        cfg = self.cfg
        x = samples_u32.reshape(-1, nb * cfg.block_size)
        if self.backend.name == "jax" and nb == cfg.rsi and x.shape[0] > 1:
            # binary-decompose the RSI count: a caller feeding irregular
            # chunk sizes would otherwise jit-compile one program per
            # distinct count; power-of-two pieces bound the cache to
            # O(log n) shapes (mirroring decode.py's bucketing).  The
            # k/bit-cursor carries chain through the pieces exactly as
            # they do across chunks.
            i, n = 0, x.shape[0]
            while n:
                # cap pieces (1024 RSIs = 64 MiB of u32 samples at the
                # bench config) so one huge feed doesn't compile/allocate
                # an arbitrarily large program
                p = min(1 << (n.bit_length() - 1), 1024)
                self._run_one(x[i:i + p], nb)
                i += p
                n -= p
        else:
            self._run_one(x, nb)

    def _run_one(self, x, nb):
        cfg = self.cfg
        bit0 = self.bits % 8
        if self.backend.name == "jax":
            packed, bits, self.k = encode_blocks_jax(cfg, x, nb, self.k, bit0)
        else:
            packed, bits, self.k = encode_blocks_core(
                self.backend, cfg, x, nb, self.k, bit0)
        chunk = np.asarray(packed)
        if bit0 and len(self.outbuf):
            self.outbuf[-1] |= int(chunk[0])
            self.outbuf += chunk[1:].tobytes()
        else:
            self.outbuf += chunk.tobytes()
        self.bits += bits - bit0

    def feed(self, data, flush):
        """Consume input bytes; code any complete RSIs (all, on flush)."""
        from .ops import accessors

        cfg = self.cfg
        self.inbuf += data
        if data:
            self.seen_input = True
        rsi_bytes = cfg.rsi_len_bytes
        n_ready = len(self.inbuf) // rsi_bytes
        # keep one partial RSI buffered unless flushing
        take = n_ready * rsi_bytes
        todo = []
        if take:
            todo.append((self.inbuf[:take], cfg.rsi))
        rest = self.inbuf[take:]
        if flush == AEC_FLUSH:
            bsz = cfg.bytes_per_sample
            n_samples = len(rest) // bsz
            if n_samples:
                raw = np.frombuffer(bytes(rest[: n_samples * bsz]), np.uint8)
                samples = accessors.bytes_to_samples(np, raw, bsz, cfg.msb,
                                                   cfg.mask)
                nb_tail = -(-n_samples // cfg.block_size)
                pad = nb_tail * cfg.block_size - n_samples
                if pad:
                    samples = np.concatenate(
                        [samples, np.full(pad, samples[-1], np.uint32)])
                todo.append((samples, nb_tail))
            rest = bytearray()
        self.inbuf = bytearray(rest)

        for item, nb in todo:
            if isinstance(item, (bytes, bytearray)):
                bsz = cfg.bytes_per_sample
                raw = np.frombuffer(bytes(item), np.uint8)
                samples = accessors.bytes_to_samples(np, raw, bsz, cfg.msb,
                                                   cfg.mask)
            else:
                samples = item
            self._run(samples, nb)

        if flush == AEC_FLUSH and not self.flushed:
            if self.bits == 0:
                # reference flushes one zero byte even with no input
                # (encode.c:686-695)
                self.outbuf += b"\x00"
                self.bits = 8
            self.flushed = True


def aec_encode_init(strm: AecStream):
    cfg = strm._cfg()  # raises AecConfError on bad params
    strm._state = _EncState(cfg, strm._backend)
    strm.total_in = 0
    strm.total_out = 0
    return AEC_OK


def aec_encode(strm: AecStream, flush):
    st = strm._state
    data = bytes(strm.next_in[: strm.avail_in]
                 if strm.avail_in is not None else strm.next_in)
    strm.total_in += len(data)
    strm.avail_in = 0
    strm.next_in = b""
    st.feed(data, flush)

    # serve output; the trailing byte is held back while it is still
    # partial (the reference carries it in cds_buf until finalised,
    # encode.c:929-931)
    servable = len(st.outbuf)
    if not st.flushed and st.bits % 8 != 0:
        servable -= 1
    cap = strm.avail_out if strm.avail_out is not None else servable
    cap = min(cap, servable)
    emit = st.outbuf[:cap]
    del st.outbuf[:cap]
    if strm.next_out is None:
        strm.next_out = bytearray()
    strm.next_out += emit
    if strm.avail_out is not None:
        strm.avail_out -= len(emit)
    strm.total_out += len(emit)
    return AEC_OK


def aec_encode_end(strm: AecStream):
    st = strm._state
    strm._state = None
    if st is not None and not (st.flushed and not st.outbuf):
        return AEC_STREAM_ERROR
    return AEC_OK


class _DecState:
    """Incremental streaming decode state -- bounded memory.

    Complete RSIs are decoded exactly once as input accumulates (the scan
    position `pos_bit` persists across calls); only the trailing partial
    RSI is re-decoded per call, bounding per-call work by one RSI
    regardless of how the input dribbles in -- the reference achieves the
    same with its resumable FSM (decode.c:342-460), we do it by whole-RSI
    replay.  Consumed input bytes are trimmed from `inbuf` (rebasing
    `pos_bit`) and emitted output is dropped from `done_out`, so a
    drip-fed stream of any length holds O(chunk + RSI) state -- parity
    with the reference's O(rsi) decode session (decode.h:68-133)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.inbuf = bytearray()
        self.pos_bit = 0   # bit offset of the first un-decoded RSI,
        #                    relative to inbuf[0] (whole consumed bytes
        #                    are trimmed; trimming preserves pos_bit%8 so
        #                    PAD_RSI byte realignment is unaffected)
        self.done_out = bytearray()  # complete-RSI output not yet emitted
        self.complete_produced = 0   # total complete-RSI bytes ever decoded
        self.emitted = 0             # total bytes handed to the caller
        self.status = AEC_OK
        self._tail = b""       # cached partial-RSI decode
        self._status_tail = AEC_OK
        self._tail_len = -1    # input length the cache was computed at

    def take(self, cap):
        """Decode newly completed RSIs, return (status, fresh bytes)."""
        cfg = self.cfg
        rsi_bytes = cfg.rsi_len_bytes
        if self.status != AEC_OK:
            # sticky error: the reference stops producing on DATA_ERROR
            return self.status, b""
        if native.get_lib() is not None:
            data = bytes(self.inbuf)
            n_new, end_bit = native.scan_rsis(data, self.pos_bit, 1 << 40,
                                              cfg)
            if n_new:
                st, out = native.decode(data, n_new * rsi_bytes, cfg,
                                        start_bit=self.pos_bit)
                # tail bytes handed out earlier are re-produced by the
                # complete-RSI decode; skip the already-emitted overlap
                overlap = max(0, self.emitted - self.complete_produced)
                self.done_out += out[overlap:]
                self.complete_produced += len(out)
                self.pos_bit = end_bit
                self._tail_len = -1  # tail moved; invalidate cache
                if st != AEC_OK:
                    self.status = st
                # trim consumed whole input bytes, rebasing the cursor
                adv = self.pos_bit // 8
                if adv:
                    del self.inbuf[:adv]
                    self.pos_bit -= adv * 8
                    data = bytes(self.inbuf)
            # trailing partial RSI: bounded re-decode (serial core), cached
            # so output-drain calls with no new input cost nothing
            if self._tail_len != len(data):
                self._status_tail, self._tail = native.decode_tail(
                    data, self.pos_bit, rsi_bytes, cfg)
                self._tail_len = len(data)
            status = self._status_tail if self.status == AEC_OK \
                else self.status
            emit = bytearray()
            n = min(cap, len(self.done_out))
            if n:
                emit += self.done_out[:n]
                del self.done_out[:n]
            if (len(emit) < cap and not self.done_out
                    and self.status == AEC_OK):
                skip = self.emitted + len(emit) - self.complete_produced
                emit += self._tail[skip: skip + (cap - len(emit))]
            self.emitted += len(emit)
            return status, bytes(emit)

        # no native toolchain: scalar full replay (inbuf is never trimmed
        # on this path, so the replay always sees the whole stream)
        from .decode import decode_buffer_numpy

        data = bytes(self.inbuf)
        max_out = ((len(data) * 8 // (cfg.id_len + 2) + 2)
                   * 64 * cfg.block_size * cfg.bytes_per_sample)
        out_cap = min(self.emitted + cap, max_out)
        status, out = decode_buffer_numpy(data, out_cap, cfg)
        fresh = out[self.emitted: self.emitted + cap]
        self.emitted += len(fresh)
        return status, fresh


def aec_decode_init(strm: AecStream):
    cfg = strm._cfg()
    strm._state = _DecState(cfg)
    strm.total_in = 0
    strm.total_out = 0
    return AEC_OK


def aec_decode(strm: AecStream, flush):
    st = strm._state
    data = bytes(strm.next_in[: strm.avail_in]
                 if strm.avail_in is not None else strm.next_in)
    strm.total_in += len(data)
    strm.avail_in = 0
    strm.next_in = b""
    st.inbuf += data

    cap = strm.avail_out if strm.avail_out is not None else (1 << 62)
    status, emit = st.take(cap)
    if strm.next_out is None:
        strm.next_out = bytearray()
    strm.next_out += emit
    if strm.avail_out is not None:
        strm.avail_out -= len(emit)
    strm.total_out += len(emit)
    return AEC_OK


def aec_decode_end(strm: AecStream):
    strm._state = None
    return AEC_OK
