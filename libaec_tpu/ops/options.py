"""Per-block code-option search, vectorised over blocks.

The reference finds the optimal Rice split position k with a warm-started
hill-descent per block (assess_splitting_option,
/root/reference/src/encode.c:329-410), chaining state->k across the whole
stream.  That serial dependency is the main obstacle to data-parallel encode.

Data-parallel reformulation:
  1. Evaluate the CDS length L(k) for *all* candidate k in one vectorised
     sweep (<=30 candidates; the sweep is a handful of reductions per block).
  2. Express one block's warm-start walk as a function f_b : k_prev -> k_min
     over the finite domain [0, 32).  f_b is computed in closed vector form
     below (no iteration).
  3. The chain k across blocks is then an *associative* composition of the
     f_b maps -> jax.lax.associative_scan gives every block's incoming k in
     O(log n) depth.  This reproduces the reference's chosen k bit-exactly,
     including its tie-breaking behaviour on plateaus.

Lengths are exact 39-bit values represented as (hi, lo) uint32 pairs
(hi*2^16 + lo); fs_len can reach 64 * (2^32-1) ~ 2^38 which neither uint32
nor float32 can hold exactly.  The reference compares in uint64; the final
returned value is truncated to uint32 (encode.c:409) which we reproduce.

Option codes emitted by select_option:
  0 = splitting, 1 = second extension, 2 = uncompressed.
(Zero-block runs are handled upstream in ops/zeroruns.py.)
"""

from ..config import KW

OPT_SPLIT = 0
OPT_SE = 1
OPT_UNCOMP = 2

U32_MAX = 0xFFFFFFFF


def _pair_less(h1, l1, h2, l2):
    return (h1 < h2) | ((h1 == h2) & (l1 < l2))


def fs_tables(xp, d_blk):
    """fs_len(k) = sum_i(d_i >> k) for every k in [0, KW).

    d_blk: u32 [NB, bs].  Returns (Fhi, Flo): u32 [NB, KW] with
    fs_len = Fhi * 2^16 + Flo exactly (Fhi, Flo < 2^22).

    Note block_fs (encode.c:313-327) sums over the whole block including the
    reference sample position; for reference blocks d[0] == 0 so this is
    harmless and we reproduce it by construction.
    """
    d_hi = d_blk >> xp.uint32(16)
    his = []
    los = []
    for k in range(KW):
        ku = xp.uint32(k)
        his.append((d_hi >> ku).sum(axis=-1, dtype=xp.uint32))
        los.append(((d_blk >> ku) & xp.uint32(0xFFFF)).sum(axis=-1, dtype=xp.uint32))
    return xp.stack(his, axis=-1), xp.stack(los, axis=-1)


def split_len_pairs(xp, Fhi, Flo, this_bs):
    """L(k) = fs_len(k) + this_bs * (k + 1), normalised (hi,lo) pairs.

    this_bs: u32 [NB] (block_size - ref; encode.c:367,375)."""
    kk = xp.arange(KW, dtype=xp.uint32)[None, :]
    lo = Flo + this_bs[:, None] * (kk + xp.uint32(1))
    hi = Fhi + (lo >> xp.uint32(16))
    lo = lo & xp.uint32(0xFFFF)
    return hi, lo


def k_walk_maps(B, Fhi, Flo, Lhi, Llo, this_bs, kmax, searched):
    """Closed-form of the reference's warm-start walk, for every possible
    incoming k simultaneously.

    Returns maps: int32 [NB, KW]; maps[b, k0] == the k_min the reference's
    assess_splitting_option would return for this block had state->k == k0.
    Blocks with searched[b] == False get the identity map (their k passes
    through unchanged: zero blocks skip the search, encode.c:614-659).

    Derivation from encode.c:356-409 (see module docstring): with
      A(k) := (k >= kmax) | (L(k+1) >= L(k))          -- ascent stops at k
      C(j) := (j > 0) & (fs_len(j) < this_bs is false is not needed;
               precisely: fs_len(j) < this_bs) & (L(j-1) < L(j))
                                                       -- descent continues past j
    the walk returns
      k0 == 0 or !A(k0):  up(k0)   = min{k >= k0 : A(k)}
      else (turn down):   L(k0-1) < L(k0) ? maxdown(k0) : k0
      where maxdown(k0) = max{j <= k0-1 : !C(j)}.
    """
    xp = B.xp
    NB = Lhi.shape[0]
    kk = xp.arange(KW, dtype=xp.int32)[None, :]

    # A(k): ascent stops at k. Shift L left to get L(k+1); last column pads
    # with "stop" (A := True for k == KW-1, subsumed by k >= kmax since
    # kmax <= 29 < 31).
    Lhi1 = xp.pad(Lhi, ((0, 0), (0, 1)), mode="edge")[:, 1:]
    Llo1 = xp.pad(Llo, ((0, 0), (0, 1)), mode="edge")[:, 1:]
    ge_next = ~_pair_less(Lhi1, Llo1, Lhi, Llo)  # L(k+1) >= L(k)
    A = (kk >= xp.int32(kmax)) | ge_next

    # up(k0) = min{k >= k0 : A(k)} via reverse cumulative min
    up = B.cummin_rev(xp.where(A, kk, xp.int32(KW - 1)), axis=-1)

    # fs_len(j) < this_bs  (this_bs <= 64, so requires Fhi == 0)
    fs_small = (Fhi == 0) & (Flo < this_bs[:, None].astype(xp.uint32))

    # L(j-1) < L(j): shift right; column 0 unused (C(0) forced False by j>0)
    Lhim1 = xp.pad(Lhi, ((0, 0), (1, 0)), mode="edge")[:, :-1]
    Llom1 = xp.pad(Llo, ((0, 0), (1, 0)), mode="edge")[:, :-1]
    prev_lt = _pair_less(Lhim1, Llom1, Lhi, Llo)  # L(j-1) < L(j)

    C = (kk > 0) & fs_small & prev_lt
    # maxdown table: cm[j] = max{i <= j : !C(i)}; !C(0) always true
    cm = B.cummax(xp.where(~C, kk, xp.int32(-1)), axis=-1)
    # evaluated at k0-1:
    cm_m1 = xp.pad(cm, ((0, 0), (1, 0)))[:, :-1]
    prev_lt_at_k0 = prev_lt  # prev_lt[k0] is exactly L(k0-1) < L(k0)

    res_down = xp.where(prev_lt_at_k0, cm_m1, kk)
    cond_up = (kk == 0) | ~A
    f = xp.where(cond_up, up, res_down)
    f = xp.clip(f, 0, KW - 1).astype(xp.int32)

    ident = xp.broadcast_to(kk, (NB, KW)).astype(xp.int32)
    return xp.where(searched[:, None], f, ident)


def chain_k(B, maps, k_init):
    """Compose the per-block maps in stream order.

    Returns (k_in: int32 [NB] -- the k entering each block's search,
             k_out_final: the k leaving the last block, to carry across
             chunk boundaries on the host).
    """
    if B.name == "jax":
        return _chain_k_tiled(B, maps, k_init)
    xp = B.xp
    P = B.prefix_compose(maps)
    # incoming k of block b is P[b-1](k_init); block 0 sees k_init itself
    col = P[:, k_init] if isinstance(k_init, int) else xp.take_along_axis(
        P, xp.broadcast_to(xp.asarray(k_init, xp.int32).reshape(1, 1), (P.shape[0], 1)),
        axis=1)[:, 0]
    k_in = xp.concatenate(
        [xp.asarray(k_init, xp.int32).reshape(1), col[:-1]])
    return k_in, col[-1]


def _chain_k_tiled(B, maps, k_init, tile=64):
    """Tiled k-chain: big gathers (map composition over the 32-value
    domain) over every block are costly, so the chain is restructured as

      1. per-tile map totals via a `tile`-step scan (small gathers),
      2. cross-tile prefix composition via log-doubling over [NT, 32],
      3. a second `tile`-step scan distributing each tile's incoming k.

    Sequential depth is 2*tile + log NT with only [NT]-sized ops per step.
    """
    import jax

    xp = B.xp
    NB = maps.shape[0]
    NT = -(-NB // tile)
    pad = NT * tile - NB
    ident = xp.broadcast_to(xp.arange(KW, dtype=xp.int32)[None, :],
                            (pad, KW))
    m = xp.concatenate([maps, ident], axis=0) if pad else maps
    m = m.reshape(NT, tile, KW)

    # 1. tile-total maps: compose the tile's maps left-to-right
    tot = xp.broadcast_to(xp.arange(KW, dtype=xp.int32)[None, :], (NT, KW))
    for s in range(tile):
        tot = xp.take_along_axis(m[:, s, :], tot, axis=1)

    # 2. exclusive prefix composition across tiles (doubling)
    P = tot
    idx = xp.arange(NT, dtype=xp.int32)[:, None]
    s = 1
    while s < NT:
        prev = xp.pad(P[:-s], ((s, 0), (0, 0)))
        comp = xp.take_along_axis(P, prev, axis=1)
        P = xp.where(idx >= s, comp, P)
        s *= 2
    # incoming k of tile t = P[t-1](k_init)
    col = xp.take_along_axis(
        P, xp.broadcast_to(xp.asarray(k_init, xp.int32).reshape(1, 1),
                           (NT, 1)), axis=1)[:, 0]
    k_tile_in = xp.concatenate(
        [xp.asarray(k_init, xp.int32).reshape(1), col[:-1]])

    # 3. walk each tile recording per-block incoming k
    ks = []
    k_cur = k_tile_in
    for s in range(tile):
        ks.append(k_cur)
        k_cur = xp.take_along_axis(m[:, s, :], k_cur[:, None], axis=1)[:, 0]
    k_in = xp.stack(ks, axis=1).reshape(NT * tile)[:NB]
    k_final = col[-1]
    return k_in, k_final


def se_lengths(xp, d_blk, uncomp_len):
    """Second-extension CDS comparison length (assess_se_option,
    encode.c:412-434): 1 + sum over pairs of (fs + 1), or UINT32_MAX if the
    running length ever exceeds uncomp_len.

    d_blk: u32 [NB, bs]; uncomp_len: u32 [NB].
    Returns (se_len: u32 [NB], se_fs: u32 [NB, bs//2] per-pair fs values,
    exact whenever the option is viable)."""
    u32 = xp.uint32
    a = d_blk[:, 0::2]
    b = d_blk[:, 1::2]
    dsum = a + b  # may wrap in u32; detected via dsum < a below
    small = (dsum >= a) & (dsum < u32(128))
    # exact fs for small d: d*(d+1)/2 + b  (< 2^13)
    fs_exact = (dsum * (dsum + u32(1))) // u32(2) + b
    SAT = u32(1 << 20)
    fs = xp.where(small, fs_exact, SAT)
    total = u32(1) + (fs + u32(1)).sum(axis=-1, dtype=xp.uint32)
    se_len = xp.where(total > uncomp_len, u32(U32_MAX), total)
    return se_len, fs_exact


def select_option(xp, split32, se_len, uncomp_len, id_len):
    """m_select_code_option precedence (encode.c:585-612).

    split32: u32 [NB] -- L(k_min) truncated to uint32 (encode.c:409's cast);
    for id_len == 1 pass U32_MAX (splitting disabled, encode.c:595-598)."""
    u32 = xp.uint32
    pick_split = (split32 < uncomp_len) & (split32 < se_len)
    pick_uncomp = ~(split32 < uncomp_len) & (uncomp_len <= se_len)
    return xp.where(
        pick_split, xp.int32(OPT_SPLIT),
        xp.where(pick_uncomp, xp.int32(OPT_UNCOMP), xp.int32(OPT_SE)),
    )
