"""Device entropy decode: data-parallel CDS payload parsing.

Phase 2 of the two-phase decode (decode.py): the native structural scan
(native.scan_blocks) walks the stream once and emits one tiny record per
output block — (payload offset, LSB-region offset, kind|k|ref, reference
sample).  This module then decodes every block payload in parallel on the
device, replacing the reference decoder's sequential hot loop
(/root/reference/src/decode.c:222-340 bit readers, :423-502 m_split,
:560-616 m_se, :518-558 m_zero_block):

  * FS (unary) parsing: instead of a clz per code, the j-th FS value of a
    block is recovered by *rank selection* — per-word popcounts over the
    block's payload window, an inclusive prefix, then the containing word,
    its prefix rank and its value all emerge from one fused
    compare-weighted-sum over the window axis, followed by a 5-step binary
    in-word select.  All samples of all blocks resolve simultaneously.
  * k-bit LSB planes / raw uncompressed fields: fixed-stride unaligned
    field extraction (two window words + funnel shift per sample), again as
    dense selects over the window axis.
  * Second-extension unpairing in closed form (sqrt + integer correction),
    replacing the reference's 182-entry table (decode.c:679-692).
  * Zero-run blocks cost nothing: their deltas are the where() default.

Everything after the single [NB, Wf] window fetch is dense elementwise /
reduction work, with no data-dependent gathers.

Output is the mapped-delta tensor consumed by ops/unpredict.py.

A conforming CDS keeps FS bits + LSB bits strictly under uncomp_len =
block_size * bits_per_sample (selection rule, encode.c:585-612), which
bounds the whole payload window statically; the scan rejects (extremely
rare, non-conforming) oversized RSIs so they fall back to the exact serial
core instead of mis-decoding.
"""
import jax.numpy as jnp
from jax import lax

KIND_ZERO = 0
KIND_SE = 1
KIND_SPLIT = 2
KIND_UNCOMP = 3


def window_words(cfg):
    """Static per-block payload-window size in u32 words: worst-case
    conforming payload (< block_size*bits_per_sample bits, covering both
    the FS and LSB regions) plus alignment slack."""
    return (cfg.block_size * cfg.bits_per_sample) // 32 + 2


def max_fs_bits(cfg):
    """FS-region bit budget the scan enforces for device decodability.
    The LSB region's size is structural (n*k), so bounding FS bounds the
    whole payload."""
    return cfg.block_size * cfg.bits_per_sample


def swap32(w):
    """u32 byteswap from shifts and masks only.

    The native scan memcpys payload windows RAW (host byte order); the
    big-endian word interpretation every parse below relies on is
    recovered here, on device, where it fuses for free -- host-side
    bswap was a third of the structural scan's time.  On a big-endian
    host the raw memcpy already yields big-endian word values, so the
    swap is a no-op there (mirrors the __BYTE_ORDER__ guard the native
    loads use, aectpu_native.cpp load64_be)."""
    import sys

    u32 = jnp.uint32
    w = w.astype(u32)
    if sys.byteorder == "big":
        return w
    return ((w << u32(24)) | ((w & u32(0xFF00)) << u32(8))
            | ((w >> u32(8)) & u32(0xFF00)) | (w >> u32(24)))


def decode_blocks(cfg, win, fs_bit, lsb_rel, meta, ref_sample):
    """Decode all block payloads.  win: u32 [NB, Wf] per-block payload
    windows -- the Wf stream words from each payload's word, memcpy'd RAW
    by the native scan (no device-side gather; the big-endian byteswap
    happens on device, see swap32); record arrays are u32 [NB]: fs_bit is
    the payload start within window word 0, lsb_rel the LSB region's
    offset in bits relative to the payload start.
    Returns mapped deltas u32 [NB, block_size]."""
    val, fs = _decode_payload_xla(cfg, win, fs_bit, lsb_rel, meta)
    return compose_blocks(cfg, val, fs, meta, ref_sample)


def _decode_payload_xla(cfg, win, fs_bit, lsb_rel, meta):
    """XLA formulation of the payload parse.  Returns (val, fs) u32
    [NB, bs]: composed
    split/uncomp/zero deltas and raw FS values (the SE codes)."""
    u32 = jnp.uint32
    i32 = jnp.int32
    bs = cfg.block_size
    bps = cfg.bits_per_sample
    Wf = win.shape[1]  # may be bucketed below window_words(cfg)
    NB = meta.shape[0]

    kind = meta & u32(3)
    k = (meta >> u32(2)) & u32(31)
    ref = (meta >> u32(7)) & u32(1)
    is_se = kind == KIND_SE
    is_split = kind == KIND_SPLIT
    is_uncomp = kind == KIND_UNCOMP

    win = swap32(win)  # raw scan memcpy -> big-endian word values
    win = win.at[:, 0].set(win[:, 0] & (u32(0xFFFFFFFF) >> fs_bit))

    # ---- FS parse (split + SE blocks) ------------------------------------
    n_fs = jnp.where(is_split, u32(bs) - ref,
                     jnp.where(is_se, u32(bs // 2), u32(0)))
    pc = lax.population_count(win)
    cum = jnp.cumsum(pc, axis=1)  # inclusive, [NB, Wf]
    j = jnp.arange(bs, dtype=u32)
    # fused over the window axis: does word w end at rank <= j?
    le = (cum[:, None, :] <= j[None, :, None])  # [NB, bs, Wf]
    t = le.sum(axis=2, dtype=i32)               # containing word index
    ce = jnp.where(le, pc[:, None, :], u32(0)).sum(axis=2)  # cum_excl[t]
    # word w is the containing word iff le held for w-1 but not w
    le_prev = jnp.concatenate(
        [jnp.ones((NB, bs, 1), bool), le[:, :, :-1]], axis=2)
    hit = le_prev & ~le
    wsel = jnp.where(hit, win[:, None, :], u32(0)).sum(axis=2)  # [NB, bs]
    r = j[None, :] - ce  # rank of the wanted bit within its word
    # 5-step binary select of the (r+1)-th set bit from the MSB
    L = jnp.zeros((NB, bs), u32)
    for s in (16, 8, 4, 2, 1):
        cnt = lax.population_count(wsel >> (u32(32) - (L + u32(s))))
        L = L + jnp.where(cnt <= r, u32(s), u32(0))
    sel = (t.astype(u32) << u32(5)) + L - fs_bit[:, None]  # payload-relative
    prev = jnp.concatenate(
        [jnp.full((NB, 1), -1, i32), sel[:, :-1].astype(i32)], axis=1)
    fs = (sel.astype(i32) - prev - 1).astype(u32)
    fs = jnp.where(j[None, :] < n_fs[:, None], fs, u32(0))

    # ---- LSB / raw field extraction ---------------------------------------
    pos = jnp.arange(bs, dtype=u32)[None, :]
    # payload sample index feeding output position `pos` (ref shifts by one)
    pj = jnp.maximum(pos, ref[:, None]) - ref[:, None]
    keff = jnp.where(is_uncomp, u32(bps), jnp.where(is_split, k, u32(0)))
    q = fs_bit[:, None] + lsb_rel[:, None] + pj * keff[:, None]
    qw = (q >> u32(5)).astype(i32)  # window word index, in [0, Wf)
    qb = q & u32(31)
    # dense select of window words qw and qw+1
    wr = jnp.arange(Wf, dtype=i32)[None, None, :]
    w0 = jnp.where(qw[:, :, None] == wr, win[:, None, :], u32(0)).sum(axis=2)
    w1 = jnp.where((qw + 1)[:, :, None] == wr, win[:, None, :],
                   u32(0)).sum(axis=2)
    hi = w0 << qb
    lo = jnp.where(qb == 0, u32(0), w1 >> (u32(32) - jnp.maximum(qb, u32(1))))
    sh = u32(32) - jnp.maximum(keff, u32(1))[:, None]
    field = jnp.where(keff[:, None] == 0, u32(0), (hi | lo) >> sh)

    # fs value feeding output position: static 1-shift selected by ref
    fs_shift = jnp.concatenate([jnp.zeros((NB, 1), u32), fs[:, :-1]], axis=1)
    fsp = jnp.where(ref[:, None] == u32(1), fs_shift, fs)
    val = (fsp << k[:, None]) | field  # uncomp: fs==0; zero: both 0
    return val, fs


def compose_blocks(cfg, val, fs, meta, ref_sample):
    """Final per-block composition: second-extension unpairing from the raw
    FS codes, then the reference-sample stitch at output position 0."""
    u32 = jnp.uint32
    bs = cfg.block_size
    NB = meta.shape[0]
    kind = meta & u32(3)
    ref = (meta >> u32(7)) & u32(1)
    is_se = kind == KIND_SE
    pos = jnp.arange(bs, dtype=u32)[None, :]

    # pair index i from m = i(i+1)/2 + b: closed form + integer correction
    m2 = jnp.repeat(fs[:, : bs // 2], 2, axis=1)  # code m for each position
    i0 = ((jnp.sqrt(8.0 * m2.astype(jnp.float32) + 1.0) - 1.0) *
          0.5).astype(u32)

    def _corr(i):
        i = i + ((i + u32(1)) * (i + u32(2)) // u32(2) <= m2).astype(u32)
        return i - (i * (i + u32(1)) // u32(2) > m2).astype(u32)

    ii = _corr(_corr(i0))
    vb = m2 - ii * (ii + u32(1)) // u32(2)
    va = ii - vb
    se_val = jnp.where((pos & u32(1)) == 0, va, vb)

    out = jnp.where(is_se[:, None], se_val, val)
    out = jnp.where((ref[:, None] == u32(1)) & (pos == 0),
                    ref_sample[:, None], out)
    return out
