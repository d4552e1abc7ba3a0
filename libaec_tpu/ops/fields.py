"""Bit-field generation: every block expands to a fixed grid of
(width, value) fields whose concatenation is the exact CCSDS bitstream.

This replaces the reference's sequential emitters (emit/emitfs/emitblock_fs/
emitblock, /root/reference/src/encode.c:61-233) with a data-parallel
representation: a field of width w holds its value in the w low bits
(FS/unary codes are simply value 1 in width fs+1).  Widths of 0 mark unused
slots.  ops/bitpack.py turns the flat field list into packed bytes.

Layout per block: three lanes of block_size slots each, flattened in order
(S = 3 * block_size) -- built with stack+reshape rather than unaligned
concatenates:
  lane 0 (header): slot 0 = option ID (id_len bits, id_len+1 for the
      low-entropy ids), slot 1 = reference sample, rest zero-width
  lane 1 (mid):    per-sample FS part (split), raw samples (uncomp),
      per-pair SE codes (even slots), or the zero-run FS at slot 0
  lane 2 (lsb):    per-sample k LSBs (split only)
"""
from .options import OPT_SE, OPT_SPLIT, OPT_UNCOMP


def gen_fields(xp, cfg, d_blk, opt, chosen_k, ref, ref_sample, is_zero,
               zero_emit, zero_fsval, zero_ref):
    """Build widths/values u32 [NB, 3*bs].

    d_blk:      u32 [NB, bs] preprocessed samples
    opt:        i32 [NB] chosen option (valid only where ~is_zero)
    chosen_k:   i32 [NB] split position (valid where opt == SPLIT)
    ref:        bool [NB] block carries a reference sample
    ref_sample: u32 [NB] RSI reference sample (raw)
    is_zero:    bool [NB]
    zero_emit/zero_fsval/zero_ref: flattened zero-run info
    """
    u32 = xp.uint32
    NB, bs = d_blk.shape
    id_len = cfg.id_len
    bps = cfg.bits_per_sample
    bps_mask = u32((1 << bps) - 1 if bps < 32 else 0xFFFFFFFF)

    ku = chosen_k.astype(xp.uint32)[:, None]
    refu = ref.astype(u32)
    i_idx = xp.arange(bs, dtype=xp.uint32)[None, :]
    active = ~is_zero

    is_split = active & (opt == OPT_SPLIT)
    is_se = active & (opt == OPT_SE)
    is_unc = active & (opt == OPT_UNCOMP)

    # ---- header lane: option ID at slot 0, reference sample at slot 1 ----
    # split: emit(k+1, id_len); uncomp: emit(2^id_len-1, id_len);
    # se: emit(1, id_len+1); zero: emit(0, id_len+1)  (encode.c:520-583)
    id_w = xp.where(
        is_split | is_unc, u32(id_len),
        xp.where(is_se | zero_emit, u32(id_len + 1), u32(0)),
    )
    id_v = xp.where(
        is_split, ku[:, 0] + u32(1),
        xp.where(is_unc, u32((1 << id_len) - 1),
                 xp.where(is_se, u32(1), u32(0))),
    )
    # reference sample: split/se emit it separately; uncomp embeds it in the
    # raw block; zero runs carry it iff the run starts at the RSI head
    # (encode.c:571-572)
    ref_here = ((is_split | is_se) & ref) | (zero_emit & zero_ref)
    ref_w = xp.where(ref_here, u32(bps), u32(0))
    ref_v = xp.where(ref_here, ref_sample & bps_mask, u32(0))

    hdr_w = xp.where(i_idx == 0, id_w[:, None],
                     xp.where(i_idx == 1, ref_w[:, None], u32(0)))
    hdr_v = xp.where(i_idx == 0, id_v[:, None],
                     xp.where(i_idx == 1, ref_v[:, None], u32(0)))

    # ---- mid lane --------------------------------------------------------
    sample_active = i_idx >= refu[:, None]  # i in [ref, bs)

    # split FS part: width (d >> k) + 1, value 1 (emitblock_fs, :118-142)
    split_fs_w = (d_blk >> ku) + u32(1)

    # uncomp raw: ref block's slot 0 holds the raw reference sample
    # (m_encode_uncomp, :536-545)
    unc_v = xp.where(
        (i_idx == 0) & ref[:, None], ref_sample[:, None], d_blk
    ) & bps_mask

    # SE: pair p encoded at even slot 2p; width fs+1, value 1 (:547-563)
    se_w_full = _interleave_even(xp, se_pair_fs(xp, d_blk) + u32(1))

    mid_w = xp.where(
        is_split[:, None] & sample_active, split_fs_w,
        xp.where(is_unc[:, None], u32(bps),
                 xp.where(is_se[:, None], se_w_full, u32(0))),
    )
    mid_v = xp.where(
        is_split[:, None] & sample_active, u32(1),
        xp.where(is_unc[:, None], unc_v,
                 xp.where(is_se[:, None],
                          xp.where(se_w_full > 0, u32(1), u32(0)), u32(0))),
    )
    # zero-run CDS: single FS field at slot 0 (m_encode_zero, :574-579)
    zslot = (i_idx == 0) & zero_emit[:, None]
    mid_w = xp.where(zslot, zero_fsval[:, None] + u32(1), mid_w)
    mid_v = xp.where(zslot, u32(1), mid_v)

    # ---- lsb lane: split k-LSB planes (emitblock, :144-233) --------------
    kmask = xp.where(ku > 0, (u32(1) << ku) - u32(1), u32(0))
    lsb_active = is_split[:, None] & sample_active & (ku > 0)
    lsb_w = xp.where(lsb_active, ku, u32(0))
    lsb_v = xp.where(lsb_active, d_blk & kmask, u32(0))

    widths = xp.stack([hdr_w, mid_w, lsb_w], axis=1).reshape(NB, 3 * bs)
    values = xp.stack([hdr_v, mid_v, lsb_v], axis=1).reshape(NB, 3 * bs)
    return widths, values


def se_pair_fs(xp, d_blk):
    """Per-pair SE fs values; SE is only chosen when every pair is small
    (sum < 128), so the u32 computation below is exact in that case."""
    u32 = xp.uint32
    a = d_blk[:, 0::2]
    b = d_blk[:, 1::2]
    dsum = a + b
    return (dsum * (dsum + u32(1))) // u32(2) + b


def _interleave_even(xp, pairs):
    """Expand [NB, bs/2] to [NB, bs] with pairs[:, p] at column 2p."""
    NB, half = pairs.shape
    z = xp.zeros_like(pairs)
    return xp.stack([pairs, z], axis=-1).reshape(NB, 2 * half)
