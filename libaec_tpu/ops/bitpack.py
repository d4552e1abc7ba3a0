"""Data-parallel bitstream assembly.

The reference packs bits strictly sequentially with a carry byte
(emit, /root/reference/src/encode.c:61-83).  Here the whole stream is built
in parallel:

  1. exclusive prefix-sum of field widths -> exact end bit position e_i of
     every field (MSB-first global bit addressing);
  2. each field's value (always < 2^32, zero-extended) occupies the 32-bit
     window [e_i - 32, e_i); windows of *values* never overlap across fields,
     so OR == ADD;
  3. each window straddles at most two big-endian uint32 words -> two
     sorted scatter-adds build the word array;
  4. words are split into bytes.

A one-word front pad keeps indices non-negative for fields near bit 0; the
chunk's global starting bit offset (bit0, carried across host chunks) rides
into the prefix sum so chunk boundaries need only a single OR of the shared
boundary byte on the host.
"""


def pack_fields(B, widths_flat, values_flat, bit0):
    """widths/values: u32 [N] in stream order; bit0: int in [0, 8).

    Returns (bytes u8 [nbytes], total_bits int) where total_bits counts
    bit0 + sum(widths), i.e. the bit cursor at chunk end, and nbytes =
    ceil(total_bits / 8).  Byte 0 contains the partial leading bits (zeros
    below bit0) for the host to OR with the previous chunk's tail byte.
    """
    xp = B.xp
    u32 = xp.uint32
    e = B.cumsum_u32(widths_flat) + u32(bit0 + 32)
    t = e & u32(31)
    idx1 = (e >> u32(5)) - u32(1)
    idx2 = e >> u32(5)
    v = values_flat
    c1 = v >> t
    c2 = xp.where(t == 0, u32(0), v << ((u32(32) - t) & u32(31)))

    total_bits_end = int(e[-1]) if e.size else bit0 + 32
    # words needed to cover bits [0, total_bits_end) plus one slack word
    nwords = (total_bits_end + 31) // 32 + 1
    out = B.scatter_add_u32(nwords, idx1, c1, idx2, c2)
    by = words_to_bytes(xp, out)
    total_bits = total_bits_end - 32
    nbytes = (total_bits + 7) // 8
    return by[4 : 4 + nbytes], total_bits


def pack_fields_static(B, widths_flat, values_flat, bit0, nwords):
    """Shape-static variant for jit: nwords is a python int upper bound on
    the packed size ((8*nbytes_max + bit0)/32 + 2).  Returns (words u32
    [nwords], total_bits u32 scalar).  Callers slice bytes on the host."""
    xp = B.xp
    u32 = xp.uint32
    e = B.cumsum_u32(widths_flat) + (xp.asarray(bit0, u32) + u32(32))
    t = e & u32(31)
    idx1 = (e >> u32(5)) - u32(1)
    idx2 = e >> u32(5)
    v = values_flat
    c1 = v >> t
    c2 = xp.where(t == 0, u32(0), v << ((u32(32) - t) & u32(31)))
    out = B.scatter_add_u32(nwords, idx1, c1, idx2, c2)
    total_bits = e[-1] - u32(32)
    return out, total_bits


def _shift_window_right(xp, win, sh):
    """Shift a bit-window right by sh in [0,32) bits (MSB-first words).

    win: u32 [..., W]; sh: u32 [..., 1] broadcastable.  Returns [..., W+1]:
    out[j] = (win[j] >> sh) | (win[j-1] << (32-sh)), with win[-1] == 0."""
    u32 = xp.uint32
    padded = xp.pad(win, [(0, 0)] * (win.ndim - 1) + [(1, 0)])
    hi = padded[..., 1:] >> sh
    lo_src = padded[..., :-1]
    lo = xp.where(sh == 0, u32(0), lo_src << ((u32(32) - sh) & u32(31)))
    out_main = hi | lo
    # the extra trailing word catches bits shifted out of the last word
    tail = xp.where(sh == 0, u32(0),
                    win[..., -1:] << ((u32(32) - sh) & u32(31)))
    return xp.concatenate([out_main, tail], axis=-1)


def _shift_right_words_var(xp, arr, o, max_o):
    """Shift u32 windows [R, W] right by per-row o words, zero-filling.

    Per-row dynamic word offsets are applied as a binary decomposition of
    o -- log2(max_o) static pad/slice shifts gated by elementwise selects
    -- instead of a per-row gather (take_along_axis)."""
    u32 = xp.uint32
    W = arr.shape[1]
    b = 0
    while (1 << b) <= max_o:
        s = 1 << b
        if s >= W:
            shifted = xp.zeros_like(arr)
        else:
            shifted = xp.pad(arr, ((0, 0), (s, 0)))[:, :W]
        bit = ((o >> u32(b)) & u32(1)) != 0
        arr = xp.where(bit, shifted, arr)
        b += 1
    return arr


def pack_fields_grouped(B, widths, values, bit0, local_words, nwords,
                        group=64):
    """Scatter-free bit assembly (the device path).

    widths/values: u32 [NB, S] per-block field grids in stream order;
    bit0: starting bit offset in [0, 8); local_words: static words per block
    window (>= ceil(max block bits / 32) + 1 front pad word);
    nwords: static output size in words (index 0 is a front pad word).

    Three stages, all static shapes, no scatter:
      A. per-block local pack: each field's <=32 value bits land in at most
         two words of a [local_words+1] window; accumulate with a dense
         compare-sum over the (few) local words;
      B. log-tree merge of `group` consecutive block windows into one group
         window (variable bit shifts via gathers along the word axis);
      C. sequential lax.scan over groups, adding each pre-shifted group
         window into the output at its word offset (in-place
         dynamic-update-slice; grid order makes the boundary overlaps safe).

    Returns (words u32 [nwords], total_bits u32 incl. bit0).
    """
    xp = B.xp
    u32 = xp.uint32
    NB, S = widths.shape
    W0 = local_words + 1  # front pad word + payload words

    # ---- stage A: local pack ---------------------------------------------
    e = xp.cumsum(widths, axis=1, dtype=xp.uint32) + u32(32)
    t = e & u32(31)
    i1 = (e >> u32(5)) - u32(1)          # in [0, W0)
    i2 = e >> u32(5)
    c1 = values >> t
    c2 = xp.where(t == 0, u32(0), values << ((u32(32) - t) & u32(31)))
    block_bits = e[:, -1] - u32(32)

    cols = []
    for w in range(W0):
        wv = u32(w)
        acc = xp.where(i1 == wv, c1, u32(0)).sum(axis=1, dtype=xp.uint32)
        acc = acc + xp.where(i2 == wv, c2, u32(0)).sum(axis=1, dtype=xp.uint32)
        cols.append(acc)
    win = xp.stack(cols, axis=1)  # [NB, W0]
    return merge_block_windows(B, win, block_bits, bit0, local_words, nwords,
                               group)


def merge_block_windows(B, win, block_bits, bit0, local_words, nwords,
                        group=64):
    """Stages B+C of the grouped packer: merge per-block bit windows
    (win u32 [NB, local_words+1], front pad word included; block_bits u32
    [NB]) into the packed word stream."""
    xp = B.xp
    u32 = xp.uint32
    NB = win.shape[0]

    # pad block count to a multiple of `group` with empty windows
    NBp = -(-NB // group) * group
    if NBp != NB:
        win = xp.pad(win, ((0, NBp - NB), (0, 0)))
        block_bits = xp.pad(block_bits, (0, NBp - NB))

    # ---- stage B: tree merge into group windows ---------------------------
    # At each level the right sibling's window is shifted right by the left
    # sibling's bit length (o words + sh bits) and summed in.  The sub-word
    # part is two elementwise shifts; the word part uses the gather-free
    # log-decomposition shifter above.
    lens = block_bits
    levels = group.bit_length() - 1
    for lvl in range(levels):
        l_win, r_win = win[0::2], win[1::2]
        l_len, r_len = lens[0::2], lens[1::2]
        Wl = l_win.shape[1]
        o = (l_len >> u32(5))[:, None]
        sh = (l_len & u32(31))[:, None]
        W_new = 2 * Wl
        r_pad = xp.pad(r_win, ((0, 0), (0, W_new - Wl)))
        # bit shift right by sh with carry from the previous word
        prev = xp.pad(r_pad, ((0, 0), (1, 0)))[:, :-1]
        rb = (r_pad >> sh) | xp.where(
            sh == 0, u32(0), prev << ((u32(32) - sh) & u32(31)))
        # word shift right by o; l_len <= 2^lvl blocks * 32*(local_words-1)
        max_o = min(W_new, (1 << lvl) * (local_words - 1))
        contrib = _shift_right_words_var(xp, rb, o, max_o)
        win = xp.pad(l_win, ((0, 0), (0, W_new - Wl))) + contrib
        lens = l_len + r_len

    return merge_groups_scan(B, win, lens, bit0, nwords)


def merge_groups_scan(B, win, lens, bit0, nwords, unroll=None):
    """Stage C: sequential merge of group windows (win u32 [NG, GW], lens
    u32 [NG]) into the packed stream at their exclusive-prefix bit offsets.
    Returns (words u32 [nwords], total_bits u32 incl. bit0)."""
    import jax
    import jax.numpy as jnp

    xp = B.xp
    u32 = xp.uint32
    gbits = xp.cumsum(lens, dtype=xp.uint32) - lens + xp.asarray(bit0, u32)
    total_bits = (xp.cumsum(lens, dtype=xp.uint32)[-1]
                  + xp.asarray(bit0, u32))
    gofs = (gbits >> u32(5)).astype(xp.int32)
    gsh = (gbits & u32(31))[:, None]
    win_shifted = _shift_window_right(xp, win, gsh)  # [NG, GW+1]
    GW1 = win_shifted.shape[1]

    def body(buf, args):
        w, o = args
        cur = jax.lax.dynamic_slice(buf, (o,), (GW1,))
        return jax.lax.dynamic_update_slice(buf, cur + w, (o,)), None

    # the `& 0` term keeps the carry's device-varying type aligned with the
    # scanned windows when this runs inside shard_map
    buf = jnp.zeros(nwords, dtype=jnp.uint32) + (win_shifted[0, 0]
                                                 & jnp.uint32(0))
    # unrolling amortises the while-loop's per-iteration overhead, which
    # dominates this latency-bound stage.
    if unroll is None:
        unroll = 8 if win_shifted.shape[0] % 8 == 0 else 1
    elif win_shifted.shape[0] % unroll != 0:
        unroll = 1
    with jax.named_scope("merge_scan"):
        buf, _ = jax.lax.scan(body, buf, (win_shifted, gofs), unroll=unroll)
    return buf, total_bits


def words_to_bytes(xp, words):
    """Big-endian split of u32 words into bytes."""
    u32 = xp.uint32
    b0 = (words >> u32(24)).astype(xp.uint8)
    b1 = ((words >> u32(16)) & u32(0xFF)).astype(xp.uint8)
    b2 = ((words >> u32(8)) & u32(0xFF)).astype(xp.uint8)
    b3 = (words & u32(0xFF)).astype(xp.uint8)
    return xp.stack([b0, b1, b2, b3], axis=-1).reshape(-1)
