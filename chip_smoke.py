#!/usr/bin/env python3
"""Smoke run of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: the checks below
    python chip_smoke.py --quick    # compile + compare at bench width only
    python chip_smoke.py --multi    # four cards: sharded encode and decode
    python chip_smoke.py --trace D  # also write a profiler trace to D and
                                    # print per-stage device times

Bench configuration: 16-bit samples, MSB, block 64, RSI 256,
preprocessing.  The input is a smooth 16-bit field plus noise, generated
from a seed.  Everything is bit-exact or it fails:

  1. encode_buffer on a 256 MiB buffer (device route) == the native
     scalar encoder; the device encode of a 16 MiB slice == the numpy
     pipeline;
  2. decode_buffer on that stream (device route) == the input bytes and
     == the native decoder;
  3. szip.sz_decompress_batch over a few hundred 64 KiB-1 MiB chunks
     (device route) == the input chunks and the native decode of each;
  4. the ten-point device matrix (tests/device_matrix.py);
  5. native-vs-device timings from 1 to 256 MiB in alternating rounds
     (routing crossover), warm end-to-end MiB/s, and
     compiled.memory_analysis() of the encode and decode chunk programs.

The last line of standard output is one JSON object with the device as
JAX reports it.  Without a GPU the script exits non-zero before any check.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
SEED = 20260
SINGLE_MIB = 256     # main-path input
MULTI_MIB = 128      # --multi input: 1024 RSIs per card on four cards
SZIP_CHUNKS = 300
CROSSOVER_MIB = (1, 4, 16, 32, 64, 128, 256)
CROSSOVER_ROUNDS = 5
# chunk sizes of the production routes at the bench config:
# encode_buffer's 64 MiB-of-u32 budget, decode_buffer_tpu's 8M samples
ENC_CHUNK_RSIS = (64 << 20) // (16384 * 4)
DEC_CHUNK_RSIS = (8 << 20) // 16384


def log(*parts):
    print(*parts, flush=True)


def card_lines():
    """The cards' name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def bench_cfg():
    from libaec_tpu import Config
    from libaec_tpu.constants import AEC_DATA_MSB, AEC_DATA_PREPROCESS

    return Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)


def synthetic_field(n_bytes, seed=SEED):
    """A smooth 16-bit field plus noise, stored MSB: rows of 4096 samples
    with a separable wave pattern and uniform noise of +-6."""
    rng = np.random.default_rng(seed)
    n = n_bytes // 2
    cols = 4096
    rows = -(-n // cols)
    x = np.arange(cols, dtype=np.float32)[None, :]
    y = np.arange(rows, dtype=np.float32)[:, None]
    ph = rng.uniform(0, 2 * np.pi, 2).astype(np.float32)
    field = (np.float32(30000)
             + np.float32(9000) * np.sin(x * np.float32(2 * np.pi / 1500)
                                         + ph[0])
             + np.float32(7000) * np.cos(y * np.float32(2 * np.pi / 900)
                                         + ph[1]))
    field += rng.integers(-6, 7, size=(rows, cols), dtype=np.int16)
    vals = np.clip(field, 0, 65535).astype(">u2").reshape(-1)[:n]
    return vals.tobytes()


def best_time(fn, reps=3):
    """Best wall time of `reps` warm calls; fn ends in host bytes, so
    every device result has been fetched when the clock stops."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def memory_line(name, compiled):
    m = compiled.memory_analysis()
    return (f"memory {name}: argument={m.argument_size_in_bytes} "
            f"output={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
            f"alias={m.alias_size_in_bytes} "
            f"code={m.generated_code_size_in_bytes}")


def encode_program(cfg, n_rsi):
    """The compiled raw-bytes encode chunk program for n_rsi RSIs."""
    import jax
    import jax.numpy as jnp

    from libaec_tpu.encode import _jax_chunk_fn_bytes

    fn = _jax_chunk_fn_bytes(cfg, n_rsi, cfg.rsi)
    raw = jax.ShapeDtypeStruct((n_rsi * cfg.rsi_len_bytes,), jnp.uint8)
    return fn.__wrapped__.lower(raw, jnp.int32(0), jnp.uint32(0)).compile()


def decode_program(cfg, comp, n_rsi):
    """The compiled decode chunk program for the first n_rsi RSIs of comp,
    with that chunk's record arrays."""
    from libaec_tpu.decode import (_jax_decode_fn, scan_chunk_bucketed,
                                   scan_record_arrays)

    recs, cnt, _tail, _wf = scan_chunk_bucketed(comp, n_rsi, cfg)
    assert cnt == n_rsi, f"scan validated {cnt}/{n_rsi} RSIs"
    arrs = scan_record_arrays(recs)
    return _jax_decode_fn(cfg, n_rsi).lower(*arrs).compile(), arrs


def check_encode(cfg, raw):
    """encode_buffer on the default route == native scalar encoder; the
    device encode of a 16 MiB slice == the numpy pipeline."""
    from libaec_tpu import native
    from libaec_tpu.backend import NUMPY, jax_backend
    from libaec_tpu.encode import _JIT_CACHE, encode_buffer

    before = set(_JIT_CACHE)
    t0 = time.perf_counter()
    comp = encode_buffer(raw, cfg)
    t_cold = time.perf_counter() - t0
    assert set(_JIT_CACHE) - before, "encode_buffer did not take the device"
    st, comp_native = native.encode(raw, cfg, threads=1)
    assert st == 0 and comp == comp_native, \
        "device encode differs from the native scalar encoder"
    log(f"encode: {len(raw) // MIB} MiB -> {len(comp)} bytes "
        f"(ratio {len(comp) / len(raw):.4f}), == native scalar encoder, "
        f"first call {t_cold:.3f} s")

    part = raw[:16 * MIB]
    dev = encode_buffer(part, cfg, backend=jax_backend())
    assert dev == encode_buffer(part, cfg, backend=NUMPY), \
        "device encode differs from the numpy pipeline"
    log("encode: 16 MiB slice, device == numpy pipeline")
    return comp


def check_decode(cfg, raw, comp):
    """decode_buffer on the default route == input == native decode."""
    from libaec_tpu import native
    from libaec_tpu.decode import _DEC_JIT_CACHE, decode_buffer

    before = set(_DEC_JIT_CACHE)
    t0 = time.perf_counter()
    out = decode_buffer(comp, cfg, len(raw))
    t_cold = time.perf_counter() - t0
    assert set(_DEC_JIT_CACHE) - before, \
        "decode_buffer did not take the device"
    assert out == raw, "device decode differs from the input"
    st, out_native = native.decode(comp, len(raw), cfg)
    assert st == 0 and out_native == out, "native decode differs"
    log(f"decode: {len(raw) // MIB} MiB, == input == native decoder, "
        f"first call {t_cold:.3f} s")


def check_e2e_rates(cfg, raw, comp):
    from libaec_tpu.decode import decode_buffer
    from libaec_tpu.encode import encode_buffer

    mib = len(raw) / MIB
    t_enc = best_time(lambda: encode_buffer(raw, cfg), reps=2)
    t_dec = best_time(lambda: decode_buffer(comp, cfg, len(raw)), reps=2)
    log(f"e2e warm: encode_buffer {mib / t_enc:.1f} MiB/s, "
        f"decode_buffer {mib / t_dec:.1f} MiB/s over {mib:.0f} MiB "
        f"(host clock, best of 2)")


def szip_chunks(field, n_chunks, seed=SEED + 1):
    """n_chunks HDF5-style chunks of 64 KiB-1 MiB (log-uniform sizes, whole
    and partial scanlines) cut from the field."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(64 << 10), np.log(1 << 20),
                               n_chunks)).astype(np.int64) & ~1
    starts = rng.integers(0, len(field) - (1 << 20), n_chunks) & ~1
    return [field[s:s + n] for s, n in zip(starts, sizes)]


def check_szip_batch(field, n_chunks):
    from libaec_tpu import native
    from libaec_tpu.decode import _DEC_JIT_CACHE
    from libaec_tpu.szip import (SZ_MSB_OPTION_MASK, SZ_NN_OPTION_MASK,
                                 SZCom, _decompress_plan,
                                 sz_buffto_buff_compress,
                                 sz_decompress_batch)

    param = SZCom(options_mask=SZ_MSB_OPTION_MASK | SZ_NN_OPTION_MASK,
                  bits_per_pixel=16, pixels_per_block=32,
                  pixels_per_scanline=2048)
    chunks = szip_chunks(field, n_chunks)
    comps = [sz_buffto_buff_compress(c, param) for c in chunks]
    before = set(_DEC_JIT_CACHE)
    t0 = time.perf_counter()
    outs = sz_decompress_batch(comps, param, [len(c) for c in chunks])
    t_cold = time.perf_counter() - t0
    assert set(_DEC_JIT_CACHE) - before, \
        "sz_decompress_batch did not take the device"
    for i, (c, comp, out) in enumerate(zip(chunks, comps, outs)):
        assert out == c, f"batch stream {i} differs from its input"
        cfg, buf_size, post = _decompress_plan(param, len(c))
        st, ref = native.decode(comp, buf_size, cfg)
        assert st == 0 and post(ref) == out, \
            f"batch stream {i} differs from its native decode"
    total = sum(map(len, chunks))
    t = best_time(lambda: sz_decompress_batch(comps, param,
                                              [len(c) for c in chunks]),
                  reps=2)
    log(f"szip batch: {n_chunks} chunks, {total / MIB:.1f} MiB, == input "
        f"== native decode; first call {t_cold:.3f} s, warm "
        f"{total / MIB / t:.1f} MiB/s")


def check_matrix():
    sys.path.insert(0, str(ROOT / "tests"))
    import device_matrix

    t0 = time.perf_counter()
    for point in device_matrix.MATRIX:
        device_matrix.run_point(*point)
    log(f"matrix: {len(device_matrix.MATRIX)} points bit-exact on the "
        f"device paths ({time.perf_counter() - t0:.1f} s incl. compiles)")


def crossover(cfg, field, rounds=CROSSOVER_ROUNDS):
    """Warm native codec against the device path at each size, in `rounds`
    rounds that time both once in alternating order, so drift in the
    host's speed hits both alike.  Prints the median MiB/s of each and how
    many rounds the device won.  Per direction, the device wins from the
    smallest size at which it won every round there and at every larger
    size: what the routing thresholds are set from."""
    from libaec_tpu import native
    from libaec_tpu.backend import jax_backend
    from libaec_tpu.decode import decode_buffer_tpu
    from libaec_tpu.encode import encode_buffer

    B = jax_backend()
    routes = {
        "encode": (lambda raw, comp: native.encode(raw, cfg),
                   lambda raw, comp: encode_buffer(raw, cfg, backend=B)),
        "decode": (lambda raw, comp: native.decode(comp, len(raw), cfg),
                   lambda raw, comp: decode_buffer_tpu(comp, cfg, len(raw))),
    }
    swept = {d: [] for d in routes}
    for mib in CROSSOVER_MIB:
        raw = field[:mib * MIB]
        comp = encode_buffer(raw, cfg, backend=B)  # warm this shape
        assert decode_buffer_tpu(comp, cfg, len(raw)) == (0, raw)
        row = {"mib": mib}
        for d, pair in routes.items():
            t = ([], [])  # native, device
            for r in range(rounds):
                for who in ((0, 1) if r % 2 == 0 else (1, 0)):
                    t0 = time.perf_counter()
                    pair[who](raw, comp)
                    t[who].append(time.perf_counter() - t0)
            wins = sum(dv < nv for nv, dv in zip(*t))
            row[f"{d}_native"] = round(mib / float(np.median(t[0])), 1)
            row[f"{d}_device"] = round(mib / float(np.median(t[1])), 1)
            row[f"{d}_device_wins"] = f"{wins}/{rounds}"
            swept[d].append(wins == rounds)
        log("crossover " + json.dumps(row) +
            f"  (MiB/s, median of {rounds} alternating rounds)")
    win = {}
    for d, always in swept.items():
        win[d] = None
        for mib, ok in reversed(list(zip(CROSSOVER_MIB, always))):
            if not ok:
                break
            win[d] = mib
    log(f"crossover: device wins every round from encode {win['encode']} "
        f"MiB, decode {win['decode']} MiB (sizes {CROSSOVER_MIB} MiB)")


def print_memory(cfg, comp):
    rpc = ENC_CHUNK_RSIS
    log(memory_line(f"encode chunk ({rpc} RSIs)", encode_program(cfg, rpc)))
    n_dec = DEC_CHUNK_RSIS
    compiled, arrs = decode_program(cfg, comp, n_dec)
    log(memory_line(f"decode chunk ({n_dec} RSIs, window "
                    f"{arrs[0].shape[1]} words)", compiled))


def stage_times(trace_dir, programs, plane_prefix="/device:GPU"):
    """Per-stage device time from a jax.profiler trace: each device event's
    HLO op is mapped to the named scope in its metadata (encode_widen,
    encode_fields, encode_pack, merge_scan, decode_parse, decode_unpredict,
    decode_layout).  Returns ({module: {stage: ns}}, busy ns, window ns)."""
    import re

    import jax

    stages = ("merge_scan", "encode_widen", "encode_fields", "encode_pack",
              "decode_parse", "decode_unpredict", "decode_layout")
    scope_of = {}
    for text in programs:
        mod = re.search(r"HloModule (\S+?)[,\s]", text).group(1)
        for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                             text):
            st = next((s for s in stages if f"/{s}/" in m.group(2) + "/"),
                      "other")
            # kernels are named after their HLO instruction, '.' -> '_'
            scope_of[(mod, m.group(1).replace(".", "_"))] = st
    path = next(Path(trace_dir).glob("plugins/profile/*/*.xplane.pb"))
    prof = jax.profiler.ProfileData.from_file(str(path))
    out, spans, seen = {}, [], []
    for plane in prof.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            seen.append(line.name)
            for ev in line.events:
                stats = dict(ev.stats)
                mod = str(stats.get("hlo_module", ""))
                if not mod:
                    continue
                # hlo_op names the thunk (a command buffer groups several
                # kernels); the event name is the kernel itself
                st = next((scope_of[(mod, c)] for c in (
                    ev.name.replace(".", "_"),
                    str(stats.get("hlo_op", "")).replace(".", "_"))
                    if (mod, c) in scope_of), "other")
                per = out.setdefault(mod, {})
                per[st] = per.get(st, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - spans[0][0]) if spans else 0
    if not out:
        raise RuntimeError(f"no HLO-annotated device events; lines {seen}")
    return out, busy, window


def trace_stages(cfg, raw, comp, trace_dir, plane_prefix="/device:GPU"):
    """Trace one warm encode chunk and one warm decode chunk at bench width
    and print device time per stage."""
    import jax

    from libaec_tpu.decode import _jax_decode_fn
    from libaec_tpu.encode import _jax_chunk_fn_bytes

    rpc = ENC_CHUNK_RSIS
    enc = encode_program(cfg, rpc)
    fn = _jax_chunk_fn_bytes(cfg, rpc, cfg.rsi)
    xd = jax.device_put(np.frombuffer(raw[:rpc * cfg.rsi_len_bytes],
                                      np.uint8))
    n_dec = DEC_CHUNK_RSIS
    dec, arrs = decode_program(cfg, comp, n_dec)
    arrs_d = [jax.device_put(a) for a in arrs]
    dfn = _jax_decode_fn(cfg, n_dec)
    jax.block_until_ready(fn(xd, 0, 0))
    jax.block_until_ready(dfn(*arrs_d))
    jax.profiler.start_trace(trace_dir)
    for _ in range(3):
        jax.block_until_ready(fn(xd, 0, 0))
    for _ in range(3):
        jax.block_until_ready(dfn(*arrs_d))
    jax.profiler.stop_trace()
    texts = [enc.as_text(), dec.as_text()]
    for name, text in zip(("encode", "decode"), texts):
        (Path(trace_dir) / f"{name}_chunk.hlo.txt").write_text(text)
    per, busy, window = stage_times(trace_dir, texts, plane_prefix)
    for mod, st in sorted(per.items()):
        total = sum(st.values())
        parts = ", ".join(f"{k} {v / 3e6:.3f} ms" for k, v in
                          sorted(st.items(), key=lambda kv: -kv[1]))
        log(f"trace {mod}: {total / 3e6:.3f} ms device per call ({parts})")
    log(f"trace window: device busy {busy / 1e6:.3f} ms of "
        f"{window / 1e6:.3f} ms")


def run_single(args):
    from libaec_tpu import native

    assert native.get_lib() is not None, "native library failed to build"
    cfg = bench_cfg()
    t0 = time.perf_counter()
    raw = synthetic_field(SINGLE_MIB * MIB)
    log(f"input: {SINGLE_MIB} MiB synthetic field, seed {SEED} "
        f"({time.perf_counter() - t0:.2f} s)")
    if args.quick:
        from libaec_tpu.backend import jax_backend
        from libaec_tpu.decode import decode_buffer_tpu
        from libaec_tpu.encode import encode_buffer

        part = raw[:64 * MIB]
        comp = encode_buffer(part, cfg, backend=jax_backend())
        st, ref = native.encode(part, cfg, threads=1)
        assert st == 0 and comp == ref, "device encode != native"
        assert decode_buffer_tpu(comp, cfg, len(part)) == (0, part)
        log("quick: 64 MiB encode == native, device decode == input")
        print_memory(cfg, comp)
    else:
        comp = check_encode(cfg, raw)
        check_decode(cfg, raw, comp)
        check_szip_batch(raw, SZIP_CHUNKS)
        check_matrix()
        check_e2e_rates(cfg, raw, comp)
        crossover(cfg, raw)
        print_memory(cfg, comp)
    if args.trace:
        trace_stages(cfg, raw, comp, args.trace)


def run_multi(mib=MULTI_MIB):
    """Sharded encode + on-device assembly == the single-card stream;
    sharded decode == the input.  1-D mesh over the first four cards."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from libaec_tpu import native
    from libaec_tpu.decode import scan_record_arrays
    from libaec_tpu.encode import encode_buffer
    from libaec_tpu.ops import accessors, bitunpack
    from libaec_tpu.parallel.dist import (make_mesh_assembler,
                                          make_mesh_decoder,
                                          make_mesh_encoder)

    n_dev = 4
    devs = jax.devices()
    assert len(devs) >= n_dev, f"--multi needs {n_dev} cards, have {len(devs)}"
    assert native.get_lib() is not None, "native library failed to build"
    mesh = Mesh(np.array(devs[:n_dev]), ("data",))
    cfg = bench_cfg()
    per_shard = mib * MIB // cfg.rsi_len_bytes // n_dev
    assert per_shard >= 64, "at least 64 RSIs per shard"
    n_rsi = per_shard * n_dev
    raw = synthetic_field(n_rsi * cfg.rsi_len_bytes)
    samples = accessors.bytes_to_samples(
        np, np.frombuffer(raw, np.uint8), cfg.bytes_per_sample, cfg.msb,
        cfg.mask).reshape(n_rsi, cfg.samples_per_rsi)
    x = jax.device_put(samples, NamedSharding(mesh, P("data", None)))
    shards = x.addressable_shards
    assert len({s.device for s in shards}) == n_dev and all(
        s.data.shape == (per_shard, cfg.samples_per_rsi) for s in shards), \
        "input is not sharded one slice per card"

    enc = make_mesh_encoder(cfg, per_shard, mesh)
    shifted, bits, offs, _k = enc(x, 0)
    W = shifted.shape[1]
    asm = make_mesh_assembler(mesh, W, n_dev * W + 2, n_dev)
    words = asm(shifted, bits, offs)
    end_bits = int(np.asarray(offs)[-1]) + int(np.asarray(bits)[-1])
    by = np.asarray(words).astype(">u4").view(np.uint8)
    got = by[4:4 + (end_bits + 7) // 8].tobytes()
    single = encode_buffer(raw, cfg)
    assert got == single, "sharded encode differs from the one-card stream"
    t_mesh = best_time(lambda: jax.block_until_ready(
        asm(*enc(x, 0)[:3])))
    t_one = best_time(lambda: encode_buffer(raw, cfg))
    log(f"multi encode: {len(raw) // MIB} MiB over {n_dev} cards "
        f"({per_shard} RSIs/shard) == one-card stream; warm mesh "
        f"encode+assembly {len(raw) / MIB / t_mesh:.1f} MiB/s (device, "
        f"input resident), one-card encode_buffer "
        f"{len(raw) / MIB / t_one:.1f} MiB/s (end to end)")

    recs, n_ok, _ = native.scan_blocks(single, n_rsi,
                                       bitunpack.max_fs_bits(cfg), cfg,
                                       wf=bitunpack.window_words(cfg))
    assert n_ok == n_rsi, f"scan validated {n_ok}/{n_rsi} RSIs"
    arrs = [jax.device_put(a, NamedSharding(
        mesh, P("data", *([None] * (a.ndim - 1)))))
        for a in scan_record_arrays(recs)]
    dec = make_mesh_decoder(cfg, per_shard, mesh)
    out = dec(*arrs)
    assert np.asarray(out).tobytes() == raw, \
        "sharded decode differs from the input"
    t_dec = best_time(lambda: jax.block_until_ready(dec(*arrs)))
    log(f"multi decode: == input; warm mesh payload decode "
        f"{len(raw) / MIB / t_dec:.1f} MiB/s (device, records resident)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four-card sharded encode and decode only")
    ap.add_argument("--quick", action="store_true",
                    help="compile and compare at bench width, then stop")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a profiler trace and print stage times")
    args = ap.parse_args(argv)
    if args.trace:
        # compile afresh: a cached executable keeps the metadata of
        # whichever compile stored it, and the trace reduction reads the
        # named scopes from that metadata
        import jax

        jax.config.update("jax_enable_compilation_cache", False)

    cards = card_lines()  # fails without nvidia-smi
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {dev.platform})")
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    if args.multi:
        run_multi()
    else:
        run_single(args)
    log(f"total {time.perf_counter() - t0:.1f} s")
    for ln in cards:
        log(f"card: {ln}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
