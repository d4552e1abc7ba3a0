"""Multi-chip / multi-host encode over a jax.sharding.Mesh.

The format's only encode-side parallelism is data-parallel over RSIs
(SURVEY.md §2): the predictor resets at every RSI and zero-runs cannot cross
one.  Two quantities chain across the *whole stream* and therefore across
shards:

  * the warm-started split position k (state->k): handled exactly by
    composing each shard's total k-map (a 32-entry function table) with an
    all_gather -- the same associative trick used within a chunk, lifted to
    the mesh level;
  * the output bit offset: an all_gather of per-shard bit lengths and an
    exclusive prefix sum; each shard pre-shifts its packed words by its
    global offset mod 32 so the host (or a ragged all-to-all) can assemble
    the final byte stream with pure ORs.

Shard-count invariance (N-chip output bit-identical to 1-chip) follows by
construction and is asserted in tests/test_dist.py.
"""
from functools import partial

import numpy as np


def _encode_shard_core(B, cfg, nb, x, k_init, axis_name):
    """Runs inside shard_map: x is this shard's RSI rows.

    Phase 1 computes the shard's total k-map for the cross-shard chain;
    phase 2 runs the single-chip pipeline with the exact incoming k."""
    import jax
    import jax.numpy as jnp

    from ..encode import pipeline_fields, worst_case_bits_per_block
    from ..ops import bitpack, options

    xp = B.xp

    # phase 1: this shard's total k-map (composition of its block maps)
    bs = cfg.block_size
    n_rsi = x.shape[0]
    NB = n_rsi * nb
    if cfg.preprocess:
        from ..ops import preprocess as pp_ops

        d, _ = pp_ops.delta_map(xp, x, cfg)
    else:
        d = x
    d_blk = d.reshape(NB, bs)
    refu = ((xp.arange(NB, dtype=xp.int32) % nb) == 0).astype(xp.uint32) \
        if cfg.preprocess else xp.zeros(NB, xp.uint32)
    this_bs = xp.uint32(bs) - refu
    is_zero = (d_blk == 0).all(axis=-1)
    if cfg.id_len > 1:
        Fhi, Flo = options.fs_tables(xp, d_blk)
        Lhi, Llo = options.split_len_pairs(xp, Fhi, Flo, this_bs)
        maps = options.k_walk_maps(B, Fhi, Flo, Lhi, Llo, this_bs,
                                   cfg.kmax, ~is_zero)
        P = B.prefix_compose(maps)
        shard_map_total = P[-1]  # [32]
    else:
        shard_map_total = xp.arange(32, dtype=xp.int32)

    # chain across shards: gather every shard's total map, compose prefixes
    all_maps = jax.lax.all_gather(shard_map_total, axis_name)  # [S, 32]
    idx = jax.lax.axis_index(axis_name)

    def compose_prefix(carry, m):
        return m[carry], None

    # incoming k for this shard = (M_{s-1} ∘ ... ∘ M_0)(k_init)
    def apply_up_to(i):
        def body(s, kacc):
            return jnp.where(s < i, all_maps[s, kacc], kacc)

        # initial carry must be device-varying to match the loop output
        k0 = jnp.int32(k_init) + 0 * i
        return jax.lax.fori_loop(0, all_maps.shape[0], body, k0)

    k_in_shard = apply_up_to(idx)

    # phase 2: full pipeline with the exact incoming k, local pack at bit 0
    worst = worst_case_bits_per_block(cfg)
    local_words = (worst + 31) // 32 + 1
    w, v, k_out = pipeline_fields(B, cfg, x, nb, k_in_shard)
    gw1 = 64 * (local_words + 1) + 1
    nwords = (NB * worst + 8) // 32 + gw1 + 2
    words, total_bits = bitpack.pack_fields_grouped(
        B, w.reshape(NB, -1), v.reshape(NB, -1), 0, local_words,
        nwords, 64)

    # global bit offsets via all_gather + exclusive prefix sum
    lens = jax.lax.all_gather(total_bits, axis_name)  # [S]
    my_off = jnp.where(
        jnp.arange(lens.shape[0]) < idx, lens, jnp.uint32(0)
    ).sum(dtype=jnp.uint32)
    # pre-shift local words so host assembly is a pure OR at byte offsets
    shifted = bitpack._shift_window_right(
        xp, words[None, :], (my_off & jnp.uint32(31))[None, None])[0]
    # rank-0 per-shard values need a singleton axis for out_specs concat
    return (shifted[None, :], total_bits.reshape(1), my_off.reshape(1),
            k_out.reshape(1))


def make_mesh_encoder(cfg, n_rsi_per_shard, mesh, axis_name="data"):
    """Returns a jitted shard_map'ed encode step over the mesh.

    Input: samples u32 [n_shards * n_rsi_per_shard, samples_per_rsi] sharded
    on rows.  Output per shard: pre-shifted packed words, bit length, global
    bit offset, outgoing k."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..backend import jax_backend

    B = jax_backend()
    nb = cfg.rsi

    fn = shard_map(
        partial(_encode_shard_core, B, cfg, nb, axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=(P(axis_name, None), P(axis_name), P(axis_name), P(axis_name)),
    )
    jfn = jax.jit(fn)

    def run(x, k_init=0):
        import jax.numpy as jnp

        return jfn(x, jnp.int32(k_init))

    return run


def make_mesh_decoder(cfg, n_rsi_per_shard, mesh, axis_name="data"):
    """Sharded phase-2 decode over the mesh.

    Phase 1 (the host-side structural scan, native.scan_blocks) is serial
    per stream; its per-block records -- including the materialised payload
    windows -- are embarrassingly parallel to consume, so the mesh program
    shards RSI batches of records across chips: each shard runs the device
    entropy decode (ops/bitunpack.py), the lane-parallel inverse predictor
    and the byte layout locally on its slice.  Nothing is replicated and no
    collectives are needed: output bytes are fixed-stride per RSI, so the
    result is sharded on the same axis.

    Returns run(win, fs_bit, lsb_rel, meta, ref_sample) ->
    u8 [n_shards * shard_bytes]."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops import bitunpack
    from ..ops.unpredict import samples_to_bytes_device, unpredict_rsis

    S = cfg.samples_per_rsi

    def shard_fn(win, fs_bit, lsb_rel, meta, ref_sample):
        deltas = bitunpack.decode_blocks(cfg, win, fs_bit, lsb_rel, meta,
                                         ref_sample)
        samples = unpredict_rsis(cfg, deltas.reshape(n_rsi_per_shard, S))
        return samples_to_bytes_device(cfg, samples.reshape(-1))

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    return jax.jit(fn)


def make_mesh_assembler(mesh, W, nwords, n_shards, axis_name="data"):
    """On-device ordered ragged assembly of per-shard packed substreams.

    Replaces assemble_host's host loop with a mesh program: each shard
    all_gathers every shard's pre-shifted window (one collective over the
    interconnect -- substreams are bit-ragged, so a fixed-bucket all_to_all
    would still ship every boundary-straddling word; the gather keeps the
    placement exact and simple) and then builds its own contiguous slice
    of the final word stream with one clamped dynamic_slice per source
    shard.  Word i of the output is owned by shard i // (nwords/n_shards),
    so the result is evenly sharded and a host fetch is a straight
    device-to-host copy of the content prefix.

    Returns run(shifted [n_shards, W], total_bits [n_shards],
    offsets [n_shards]) -> words u32 [nwords] (sharded on axis_name).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    Wout = -(-nwords // n_shards)
    nwords_pad = Wout * n_shards

    def shard_fn(shifted, offsets):
        # shifted arrives [n_shards, W] (replicated via all_gather below),
        # offsets [n_shards] u32 bit offsets
        allw = jax.lax.all_gather(shifted[0], axis_name)   # [S, W]
        offs = jax.lax.all_gather(offsets[0], axis_name)   # [S]
        s = jax.lax.axis_index(axis_name)
        out = jnp.zeros(Wout, jnp.uint32)
        base = s * Wout
        for g in range(n_shards):
            ow = (offs[g] >> jnp.uint32(5)).astype(jnp.int32)
            # pad front/back by Wout so out-of-range (no-overlap) cases
            # read zeros; clamp explicitly -- dynamic_slice's own clamp is
            # not defined for negative starts
            padded = jnp.pad(allw[g], (Wout, Wout))
            start = jnp.clip(base - ow + Wout, 0, W + Wout)
            out = out | jax.lax.dynamic_slice(padded, (start,), (Wout,))
        return out[None, :]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name)),
        out_specs=P(axis_name, None),
    )
    jfn = jax.jit(fn)

    def run(shifted, total_bits, offsets):
        del total_bits  # lengths are implicit in the next shard's offset
        words = jfn(shifted, offsets).reshape(-1)
        return words[:nwords] if nwords_pad != nwords else words

    return run


def assemble_host(shifted_words, total_bits, offsets):
    """Host-side ordered ragged assembly of per-shard packed substreams.

    shifted_words: [S, W] u32 pre-shifted by (offset % 32); offsets/bits:
    [S] u32.  Returns the final byte stream."""
    shifted_words = np.asarray(shifted_words)
    total_bits = np.asarray(total_bits)
    offsets = np.asarray(offsets)
    end_bits = int(offsets[-1]) + int(total_bits[-1])
    nwords = (end_bits + 31) // 32 + 2
    out = np.zeros(nwords, np.uint32)
    for s in range(shifted_words.shape[0]):
        o = int(offsets[s]) >> 5
        span_bits = int(total_bits[s]) + (int(offsets[s]) & 31)
        span = span_bits // 32 + 2
        span = min(span, shifted_words.shape[1], nwords - o)
        out[o : o + span] |= shifted_words[s, :span]
    by = out.astype(">u4").view(np.uint8)
    nbytes = (end_bits + 7) // 8
    return by[4 : 4 + nbytes].tobytes()
