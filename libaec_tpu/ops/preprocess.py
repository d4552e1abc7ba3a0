"""Unit-delay predictor + sign mapper (the CCSDS 121 pre/post-processor).

Data-parallel design: unlike the reference's serial scan
(preprocess_unsigned/preprocess_signed, /root/reference/src/encode.c:235-311),
the forward Δ-map only depends on (x[i], x[i-1]); with the shifted input
materialised it is a fully parallel elementwise map over [n_rsi, S].

All arithmetic is uint32/int32 with wraparound, matching C semantics exactly.
The inverse map (decode.c:67-141 FLUSH macro) *is* a true sequential scan per
RSI; see ops/unpredict.py.
"""


def delta_map_unsigned(xp, x, xmax):
    """Forward preprocessor for unsigned samples.

    x: u32 [n_rsi, S]; returns d: u32 [n_rsi, S] with d[:, 0] = 0.
    Semantics of encode.c:255-269.
    """
    u32 = xp.uint32
    # shift-right-by-one with edge replication
    xprev = xp.pad(x, ((0, 0), (1, 0)), mode="edge")[:, :-1]
    ge = x >= xprev
    D = xp.where(ge, x - xprev, xprev - x)
    two = u32(2)
    d_ge = xp.where(D <= xprev, two * D, x)
    d_lt = xp.where(D <= u32(xmax) - xprev, two * D - u32(1), u32(xmax) - x)
    d = xp.where(ge, d_ge, d_lt)
    return xp.where(
        xp.arange(x.shape[1], dtype=xp.uint32)[None, :] == 0, u32(0), d
    )


def delta_map_signed(xp, x_raw, bits_per_sample, xmax, xmin):
    """Forward preprocessor for signed samples (encode.c:286-309).

    x_raw: u32 [n_rsi, S] raw (not sign-extended) sample values.
    Returns d: u32 with d[:, 0] = 0.
    """
    u32, i32 = xp.uint32, xp.int32
    m = u32((1 << (bits_per_sample - 1)) & 0xFFFFFFFF)
    # sign extension (x ^ m) - m, evaluated in uint32, viewed as int32
    sx = ((x_raw ^ m) - m).astype(i32)
    sxprev = xp.pad(sx, ((0, 0), (1, 0)), mode="edge")[:, :-1]
    # xmax/xmin arrive as u32 bit patterns; reinterpret as int32
    sxmax = (xp.zeros((), dtype=xp.uint32) + u32(xmax)).astype(i32)
    sxmin = (xp.zeros((), dtype=xp.uint32) + u32(xmin)).astype(i32)

    lt = sx < sxprev
    D = xp.where(lt, (sxprev - sx), (sx - sxprev)).astype(u32)
    two = u32(2)
    d_lt = xp.where(
        D <= (sxmax - sxprev).astype(u32), two * D - u32(1),
        (sxmax - sx).astype(u32),
    )
    d_ge = xp.where(
        D <= (sxprev - sxmin).astype(u32), two * D,
        (sx - sxmin).astype(u32),
    )
    d = xp.where(lt, d_lt, d_ge)
    return xp.where(
        xp.arange(x_raw.shape[1], dtype=xp.uint32)[None, :] == 0, u32(0), d
    )


def delta_map(xp, x_raw, cfg):
    """Dispatch on signedness; returns (d, ref_samples).

    ref_samples are the *raw* first samples of each RSI (the encoder emits
    them unmodified, masked to bits_per_sample; encode.c:525-527).
    """
    if cfg.signed:
        d = delta_map_signed(xp, x_raw, cfg.bits_per_sample, cfg.xmax, cfg.xmin)
    else:
        d = delta_map_unsigned(xp, x_raw, cfg.xmax)
    return d, x_raw[:, 0]
