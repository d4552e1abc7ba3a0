"""Zero-block run segmentation, reformulated as parallel segmented ops.

The reference aggregates consecutive all-zero blocks in FSM state
(m_check_zero_block / m_encode_zero, /root/reference/src/encode.c:565-659):
a run is emitted when a non-zero block arrives, at the end of the RSI
(blocks_avail == 0) or at a 64-block segment boundary
(blocks_dispensed % 64 == 0), with runs > 4 at a segment/RSI end collapsing
to the ROS (remainder-of-segment) marker.

Data-parallel: runs are computed combinatorially per RSI row.  A run's CDS is
attributed to its *last* zero block, which in stream order lands exactly
where the reference emits it (before the triggering non-zero block's CDS).
"""


def zero_run_info(B, z, nb, pp):
    """z: bool [n_rsi, nb] block-is-all-zero.

    Returns dict of [n_rsi, nb] arrays:
      emit:      True at blocks that emit a zero-run CDS
      fsval:     the FS value coded for the run (valid at emit)
      zero_ref:  run includes the RSI's reference sample (valid at emit)
    """
    xp = B.xp
    b = xp.arange(nb, dtype=xp.int32)[None, :]
    seg_first = (b % 64) == 0
    seg_last = ((b % 64) == 63) | (b == nb - 1)

    zprev = xp.pad(z, ((0, 0), (1, 0)))[:, :-1]
    znext = xp.pad(z, ((0, 0), (0, 1)))[:, 1:]

    run_start = z & (seg_first | ~zprev)
    run_end = z & (seg_last | ~znext)

    start_idx = B.cummax(xp.where(run_start, b, xp.int32(-1)), axis=-1)
    n_run = b - start_idx + 1  # valid at run_end positions

    ros = run_end & seg_last & (n_run > 4)
    fsval = xp.where(
        ros, xp.int32(4), xp.where(n_run >= 5, n_run, n_run - 1)
    ).astype(xp.uint32)
    zero_ref = run_end & (start_idx == 0) if pp else xp.zeros_like(run_end)

    return {"emit": run_end, "fsval": fsval, "zero_ref": zero_ref}
