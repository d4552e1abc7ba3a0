"""Inverse of the unit-delay predictor + sign mapper, on device.

Reference semantics: the FLUSH macro (/root/reference/src/decode.c:67-141).
The recurrence last' = f(last, d) is sequential *within* an RSI, but every
RSI starts from an absolute reference sample when preprocessing is on
(decode.c:410-413), so RSIs are independent: put RSIs on lanes and scan over
the sample index -- one lax.scan of vector steps instead of a scalar loop.

This is phase 2 of the two-phase decode (SURVEY.md §2): phase 1 (the native
structural/entropy scan) produces mapped deltas; this kernel reconstructs
samples and the byte layout.
"""
import jax
import jax.numpy as jnp

# Scan steps per loop iteration.  XLA on a GPU runs each while-loop
# iteration as a host round trip plus a few kernel launches, so the cost of
# the 16,383-step scan of the bench config follows the iteration count:
# on an H100, 64 steps per iteration made the 512-RSI decode chunk ~4.5x
# faster than 8, but its compile (plus first call) rose from ~0.5 s to
# ~12.5 s, paid once per decode program shape unless the compile cache
# holds it; 256 gained little more at 2.3x that compile time (PERF.md).
SCAN_UNROLL = 64


def unpredict_rsis(cfg, deltas):
    """deltas: u32 [n_rsi, S] mapped prediction residuals (first sample of
    each row is the absolute reference).  Returns u32 [n_rsi, S] samples."""
    if not cfg.preprocess:
        return deltas
    u32, i32 = jnp.uint32, jnp.int32
    bps = cfg.bits_per_sample
    xmax = jnp.uint32(cfg.xmax)

    ref = deltas[:, 0]
    signed_path = cfg.xmin != 0  # decode.c:91,111 branches on xmin == 0

    if cfg.signed:
        m = u32((1 << (bps - 1)) & 0xFFFFFFFF)
        ref = (ref ^ m) - m  # sign-extend reference (decode.c:80-85)

    if signed_path:
        sxmax = xmax.astype(i32)
        state0 = ref.astype(i32)

        def step(last, d):
            du = d
            half = (du >> u32(1)) + (du & u32(1))
            zig = ((du >> u32(1)) ^ (~((du & u32(1)) - u32(1)))).astype(i32)
            neg = last < 0
            lim = jnp.where(neg, (sxmax + last + 1).astype(u32),
                            (sxmax - last).astype(u32))
            esc = jnp.where(neg, du.astype(i32) - sxmax - 1,
                            sxmax - du.astype(i32))
            nxt = jnp.where(half <= lim, last + zig, esc)
            return nxt, nxt

        _, rest = jax.lax.scan(step, state0, deltas[:, 1:].T, unroll=SCAN_UNROLL)
        out = jnp.concatenate([state0[:, None], rest.T], axis=1)
        return out.astype(u32)

    med = xmax // u32(2) + u32(1)
    state0 = ref.astype(u32)

    def step(last, d):
        half = (d >> u32(1)) + (d & u32(1))
        zig = (d >> u32(1)) ^ (~((d & u32(1)) - u32(1)))
        mask = jnp.where((last & med) != 0, xmax, u32(0))
        nxt = jnp.where(half <= (mask ^ last), last + zig, mask ^ d)
        return nxt, nxt

    _, rest = jax.lax.scan(step, state0, deltas[:, 1:].T, unroll=SCAN_UNROLL)
    return jnp.concatenate([state0[:, None], rest.T], axis=1)


def samples_to_bytes_device(cfg, samples):
    """u32 [n] samples -> the stream's byte layout (decode.c:144-189 put_*
    equivalents), on device.

    Returns the output as packed little-endian u32 *words* whenever the
    total byte count divides by 4 (always true for whole RSIs): building
    words arithmetically keeps everything in 32-bit lanes instead of u8
    stacking and relayout.  The host views the fetched buffer
    as bytes (np.view(uint8)); callers needing device-side u8 get it via
    the bitcast fallback."""
    u32 = jnp.uint32
    bsz = cfg.bytes_per_sample
    n = samples.shape[0]

    def byte(v, i):  # i-th stream byte of each sample, as u32
        sh = 8 * ((bsz - 1 - i) if cfg.msb else i)
        return (v >> u32(sh)) & u32(0xFF)

    if (n * bsz) % 4 == 0:
        spw = 4 // bsz if bsz in (1, 2, 4) else 4  # samples per word group
        if bsz == 4:
            w = samples
            if cfg.msb:
                w = ((w >> u32(24)) | ((w >> u32(8)) & u32(0xFF00))
                     | ((w << u32(8)) & u32(0xFF0000)) | (w << u32(24)))
            return w
        if bsz in (1, 2):
            g = samples.reshape(n // spw, spw)
            word = jnp.zeros((n // spw,), u32)
            for s in range(spw):
                for b in range(bsz):
                    word = word | (byte(g[:, s], b) << u32(8 * (s * bsz + b)))
            return word
        # bsz == 3: 4 samples -> 3 words
        g = samples.reshape(n // 4, 4)
        sbytes = [byte(g[:, s], b) for s in range(4) for b in range(3)]
        words = [
            sbytes[4 * wi] | (sbytes[4 * wi + 1] << u32(8))
            | (sbytes[4 * wi + 2] << u32(16)) | (sbytes[4 * wi + 3] << u32(24))
            for wi in range(3)
        ]
        return jnp.stack(words, axis=-1).reshape(-1)

    sh = range(8 * (bsz - 1), -8, -8) if cfg.msb else range(0, 8 * bsz, 8)
    parts = [((samples >> u32(s)) & u32(0xFF)).astype(jnp.uint8) for s in sh]
    return jnp.stack(parts, axis=-1).reshape(-1)
