"""Smoke run of the PyTorch port (datok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure raises and the script exits nonzero:

1. device: needs CUDA; prints the card's name and power limit;
2. build: builds K1 (csrc/transduce.cu), KF and KP from the
   repository's sources, all at once, one ``nvcc`` each;
3. kernel vs plain: K1 and the plain PyTorch machine on the same CUDA
   tensors (full-size synthetic model, B=4096 x L=256) must agree
   exactly; both are timed in turns (plain, kernel, kernel, plain);
4. main path: one wave of B=32768 x L=1024 through
   ``BatchEngine(tok, device="cuda").events_batch`` and the native
   writer; K1 must have launched, every lane must equal the native
   oracle, and 64 sampled lanes must be byte-equal to ``tok.tokenize``;
   then K1 and the plain machine run the wave's own tensors, must agree
   exactly and are timed in turns;
5. the DE model, when ``DATOK_DE_MODEL`` names its ``.matok`` file,
   through the same path;
6. the probe kernels: KF (``csrc/hot_fetch.cu``, select on and off) and
   KP (``csrc/micro_fused.cu``) at the TPU probes' default size
   (B=16384, H=384, K=64) on the probes' seeded inputs plus
   out-of-range lanes must equal their plain versions exactly; both
   are timed in turns; then the three probe scripts
   (``datok_tpu_torch.bench_micro``) run once each, and each must have
   launched its kernel;
7. streaming at real size: a ~32 MB stream (about 2,000 documents of
   1-16 KB, each ending in ``\\x04\\n``, and 16 documents of 0.5-1.5 MB
   without EOT, which take the long path) through ``tokenize_stream``
   (``long_strategy`` "auto" and "chained") and ``tokenize_reader``
   (4 MB chunks); each output must be byte-equal to the native oracle
   over the whole stream as one lane, and K1 must have launched;
8. the overlapped pipeline: phase 4's 32,768 texts as one ~30 MB
   stream of documents ending in ``\\x04\\n`` through
   ``tokenize_stream_pipelined`` (lanes=8192 with pack_len=0, and the
   defaults) and the serial ``tokenize_stream``, then phase 7's stream
   through ``tokenize_stream_pipelined`` (its long documents take the
   long route inside the prep thread); each output byte-equal to the
   native oracle, K1 launched, the stage seconds printed beside the
   wall time;
9. the corpus runner and the CLI: the model saved as a ``.matok``, 64
   files cut from phase 8's documents (4 ending mid-word without EOT,
   1 empty) through ``datok_tpu_torch.cli.main(["corpus", ...])``, each
   output byte-equal to the native oracle; a second run must skip all
   64 files and launch K1 zero times; and ``python -m
   datok_tpu_torch.cli tokenize --batch --device cuda`` on one file in a
   subprocess must print the oracle's bytes.

``--profile`` adds a breakdown of the phase-4 wave after phase 4: each
stage timed on the host clock between ``torch.cuda.synchronize()``
calls (three repetitions after a warm-up), ``events_batch`` alone, and
a ``torch.profiler`` table of one ``events_batch`` with the card's idle
share; and after phase 7 a ``cProfile`` table of one more
``tokenize_stream``; and after phase 8, for one pipelined run, a
``torch.profiler`` table with the card's idle share and a ``cProfile``
table of all its threads, and the host time of the EOT split and the
entry prediction alone.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches on its paths (K1: phase 4's wave,
phase 8's runs and phase 9's first corpus run; KF and KP: their probe
scripts), its largest error against the plain version and both times
at its path's shape.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# bench.py:78-86, the JAX package's benchmark text
BENCH_TEXT = """Der Vorsitzende der Abk. hat gewählt. Gefunden auf wikipedia.org. Ich bin unter korap@ids-mannheim.de erreichbar.
Unsere Website ist https://korap.ids-mannheim.de/?q=Baum. Unser Server ist 10.0.10.51. Zu 50.4% ist es sicher.
Der Termin ist am 5.9.2018.
Ich habe die readme.txt heruntergeladen.
Ausschalten!!! Hast Du nicht gehört???
Ich wohne in der Weststr. und Du? Kupietz und Schmidt [2018]: Korpuslinguistik. Dieses verf***** Kleid! Ich habe die readme.txt heruntergeladen.
Er sagte: \"Es geht mir gut!\", daraufhin ging er. &quot;Das ist von C&A!&quot; Früher bzw. später ... Sie erreichte den 1. Platz!
Archive:  Ich bin kein zip. D'dorf Ku'damm Lu'hafen M'gladbach W'schaft.
Mach's macht's was'n ist's haste willste kannste biste kriegste."""

# the reference DE model (tokenizer_de.matok) is not in the repository;
# phase 5 runs when this variable names it
DE_MODEL = os.environ.get("DATOK_DE_MODEL", "")
SEED = 0
CHECK_SHAPE = (4096, 256)  # (B, L) of the kernel-vs-plain phase
WAVE_SHAPE = (32768, 1024)  # (B, L) of the main-path wave, bench.py:400-401
PROBE_SHAPE = (16384, 384, 64)  # (B, H, K) defaults of the TPU probes
# phase 7's stream: documents of 1-16 KB and long ones of 0.5-1.5 MB
STREAM_DOCS = (2000, 1 << 10, 16 << 10)
STREAM_LONG = (16, 1 << 19, 3 << 19)


def cuda_ms(fn, n=1, warmup=0):
    """Mean milliseconds of ``n`` calls of ``fn`` between two CUDA
    events, after ``warmup`` untimed calls (two let the caching
    allocator hold the outputs' memory); returns (ms, last result)."""
    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, out


def masked(ev, counts):
    """Events with the unwritten columns past each lane's count zeroed."""
    keep = torch.arange(ev.shape[1], device=ev.device)[None, :] < counts[:, None]
    return torch.where(keep, ev, torch.zeros_like(ev))


def max_abs_err(a, b):
    """Largest difference between two machine results (events masked
    by their counts), as an integer."""
    pairs = [(masked(a[0], a[1]), masked(b[0], b[1]))] + list(zip(a[1:], b[1:]))
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in pairs)


def bench_lane(i, L):
    """BENCH_TEXT rotated by a per-lane offset, L characters long."""
    off = (i * 131) % len(BENCH_TEXT)
    rot = BENCH_TEXT[off:] + BENCH_TEXT[:off]
    return (rot * (L // len(rot) + 1))[:L]


def wave_texts(tok, B, L, synth_text):
    """Synthetic documents of length L/4..L, rotated BENCH_TEXT lanes
    and a few empty texts, interleaved."""
    rng = np.random.default_rng(SEED)
    n_syn = (B + 2) // 3
    syn = iter(synth_text(tok, n_syn,
                          [int(x) for x in rng.integers(L // 4, L + 1, n_syn)],
                          seed=SEED + 1))
    texts = []
    for i in range(B):
        if i % 997 == 500:
            texts.append("")
        elif i % 3 == 0:
            texts.append(next(syn))
        else:
            texts.append(bench_lane(i, L))
    return texts


def to_cuda(meta, lengths, entries=None, stops=None):
    B = meta.shape[0]
    dev = torch.device("cuda")
    if entries is None:
        entries = np.ones(B, np.int32)
    if stops is None:
        stops = np.zeros(B, bool)
    return (torch.from_numpy(meta).to(dev).t().contiguous(),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(np.asarray(entries, np.int32)).to(dev),
            torch.from_numpy(np.asarray(stops, bool)).to(dev))


def run_wave(dtt, kt, run_machine, eng, texts, card, label):
    """One wave through the main path (events_batch, then the native
    writer), checked lane by lane, then K1 against the plain machine on
    the wave's tensors; returns (K1's launches on the main path, max abs
    err, K1 ms, plain ms)."""
    tok = eng.tok
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    kt.transduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs = eng.events_batch(texts, as_arrays=True)
    counts = np.array([len(e) for e in evs], dtype=np.int32)
    lens = np.array([len(t) for t in texts], dtype=np.int32)
    offs = np.zeros(len(texts), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    cps = np.frombuffer("".join(texts).encode("utf-32-le"), dtype="<u4")
    writer = dtt.NativeWriter(dtt.SIMPLE)
    writer.feed_wave(np.concatenate(evs), counts, cps.astype(np.int32), offs, lens)
    out = writer.getvalue()
    wall = time.perf_counter() - t0
    launches = kt.transduce.launches
    if launches < 1:
        raise RuntimeError("the main path did not launch K1")
    if not out:
        raise RuntimeError("the main path formatted no output")
    print(f"{label}: main path {n_bytes / wall / 1e6:.2f} MB/s "
          f"({n_bytes} bytes in {wall:.3f} s, encode+K1+decode+format), "
          f"K1 launches {launches} [{card}]", flush=True)

    # K1 and the plain machine on the tensors the main path gives K1
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    args = (eng.tables, *to_cuda(meta, lengths), eng.max_steps_for(meta.shape[1]))
    res = kt.transduce(*args)
    err = max_abs_err(res, run_machine(*args))
    if err != 0:
        raise RuntimeError(f"{label}: K1 differs from the plain machine "
                           f"(max abs err {err})")
    # in turns: plain, kernel, kernel, plain (K1 turns: mean of 10)
    p1, _ = cuda_ms(lambda: run_machine(*args))
    k1, res = cuda_ms(lambda: kt.transduce(*args), n=10, warmup=2)
    k2, _ = cuda_ms(lambda: kt.transduce(*args), n=10, warmup=2)
    p2, _ = cuda_ms(lambda: run_machine(*args))
    ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    n_bad = int(res[2].sum())
    steps = res[4].long()
    print(f"{label}: kernel vs plain on the wave, B={meta.shape[0]} x "
          f"L={meta.shape[1]}: events/counts/bad/state/steps equal (max abs "
          f"err {err}); K1 {k1:.3f} / {k2:.3f} ms (means of 10), plain "
          f"{p1:.3f} / {p2:.3f} ms; K1 "
          f"{n_bytes / (ms / 1e3) / 1e6:.2f} MB/s device rate, "
          f"bad lanes {n_bad}, steps/char "
          f"{int(steps.sum()) / max(int(lengths.sum()), 1):.3f} [{card}]",
          flush=True)

    for i in range(len(texts)):
        ref = dtt.native_transduce_events(tok, meta[i, : lengths[i]], as_array=True)
        if ref is None:
            raise RuntimeError("native oracle unavailable")
        if not np.array_equal(ref, evs[i]):
            raise RuntimeError(f"{label}: lane {i} differs from the native "
                               f"oracle: {texts[i][:80]!r}")
    rng = np.random.default_rng(SEED + 2)
    for i in rng.choice(len(texts), 64, replace=False):
        got = dtt.format_events(evs[i], texts[i], dtt.SIMPLE)
        if got != tok.tokenize(texts[i]):
            raise RuntimeError(f"{label}: lane {i} bytes differ from "
                               f"tok.tokenize: {texts[i][:80]!r}")
    print(f"{label}: all {len(texts)} lanes equal the native oracle, "
          "64 sampled lanes byte-equal to tok.tokenize", flush=True)
    return launches, err, ms, p_ms


def profile_wave(dtt, kt, eng, texts, card, reps=3):
    """Where the wave's time goes: the main path's stages, each timed
    on the host clock between synchronizations, ``events_batch`` alone,
    and one ``events_batch`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from datok_tpu_torch.runtime.decode import decode_events_compact

    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    lens = np.array([len(t) for t in texts], dtype=np.int32)
    offs = np.zeros(len(texts), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    cps = np.frombuffer("".join(texts).encode("utf-32-le"), dtype="<u4")
    cps = cps.astype(np.int32)

    def stages():
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            now = time.perf_counter()
            t[name] = round((now - t0) * 1e3, 3)
            t0 = now

        meta, lengths, _ = eng.encoder.encode_batch(texts)
        lap("encode")
        args = (eng.tables, *to_cuda(meta, lengths), eng.max_steps_for(meta.shape[1]))
        lap("h2d+transpose")
        ev, counts, bad, _state, _steps = kt.transduce(*args)
        lap("K1")
        E = max(1, int(counts.max()))
        ev_h, counts_h, bad_h = ev[:, :E].cpu().numpy(), counts.cpu().numpy(), bad.cpu().numpy()
        lap("d2h")
        evs = decode_events_compact(ev_h, counts_h, as_arrays=True)
        lap("decode")
        writer = dtt.NativeWriter(dtt.SIMPLE)
        writer.feed_wave(np.concatenate(evs), counts_h, cps, offs, lens)
        writer.getvalue()
        lap("format")
        return t, int(bad_h.sum()), E

    for rep in range(reps + 1):
        t, n_bad, E = stages()
        total = sum(t.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.events_batch(texts, as_arrays=True)
        eb = (time.perf_counter() - t0) * 1e3
        print(f"profile{' (warm-up)' if rep == 0 else ''}: stages ms "
              f"{json.dumps(t)}, total {total:.3f} ms -> "
              f"{n_bytes / total / 1e3:.2f} MB/s; events_batch alone "
              f"{eb:.3f} ms; bad lanes {n_bad}, E {E} [{card}]", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.events_batch(texts, as_arrays=True)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    print(avg.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    # device-side rows only (kernels, copies), as the table's total
    device_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA) / 1e3
    print(f"profile: device time {device_ms:.3f} ms in one events_batch; "
          f"card idle {100 * (1 - device_ms / eb):.1f}% of the last "
          f"unprofiled events_batch ({eb:.3f} ms) and "
          f"{100 * (1 - device_ms / total):.1f}% of the last stage total "
          f"({total:.3f} ms) [{card}]", flush=True)


def probe_inputs(dev):
    """KF's and KP's inputs at the probes' default size: the probes'
    seeded planes, lanes and ring, with out-of-range values written
    into some lanes (a = 0, negative, >= 256; h < 0, >= H)."""
    from datok_tpu_torch.bench_micro.planes import (fetch_inputs,
                                                    fetch_planes_from_numpy,
                                                    fused_inputs,
                                                    fused_planes_from_numpy)
    B, H, _K = PROBE_SHAPE
    planes, a, h = fetch_inputs(B, H)
    rng = np.random.default_rng(SEED + 4)
    odd = rng.choice(B, B // 16, replace=False)
    a[odd[0::4]] = rng.choice([0, -3, 256, 1000], len(odd[0::4]))
    h[odd[1::4]] = rng.choice([-1, H, H + 7], len(odd[1::4]))
    _table, planes_i8, ring, h0 = fused_inputs(B, H)
    ring[rng.random(ring.shape) < 1 / 32] = 0
    ring[rng.random(ring.shape) < 1 / 64] = 300
    h0[odd[2::4]] = -2
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return ((t(a), t(h), fetch_planes_from_numpy(planes, dev)),
            (t(ring), fused_planes_from_numpy(planes_i8, dev), t(h0[None, :])))


def device_us(fn, n=20):
    """Device microseconds per call of ``fn`` (its kernels and copies),
    from ``torch.profiler`` over ``n`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n


def exact_err(x, y):
    return max(int((p.long() - q.long()).abs().max()) for p, q in zip(x, y))


def probe_phase(card, dev):
    """Phase 6: KF (select on and off) and KP against their plain
    versions on the same CUDA tensors, timed in turns; then the three
    probe scripts once each, with the launch counts read around each.
    Returns the kernels' entries of the final ``kernels`` line."""
    from datok_tpu_torch.bench_micro import (micro_ablate, micro_fused,
                                             micro_pallas)
    from datok_tpu_torch.kernels import hot_fetch as hf
    from datok_tpu_torch.kernels import micro_fused as mf

    B, H, K = PROBE_SHAPE
    fetch_args, fused_args = probe_inputs(dev)
    cases = [  # (name, kernel, plain, lane-steps per call)
        ("hot_fetch[select]", lambda: hf.hot_fetch(*fetch_args, 3, True),
         lambda: hf.hot_fetch_plain(*fetch_args, 3, True), B),
        ("hot_fetch[no_select]", lambda: hf.hot_fetch(*fetch_args, 3, False),
         lambda: hf.hot_fetch_plain(*fetch_args, 3, False), B),
        ("micro_fused", lambda: mf.micro_fused(*fused_args, K),
         lambda: mf.micro_fused_plain(*fused_args, K), B * K),
    ]
    res = {}
    for name, kern, plain, lane_steps in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = exact_err(got, want)
        if err != 0:
            raise RuntimeError(f"{name} differs from its plain version "
                               f"(max abs err {err})")
        # in turns: plain, kernel, kernel, plain
        p1, _ = cuda_ms(plain, n=10, warmup=2)
        k1, _ = cuda_ms(kern, n=100, warmup=2)
        k2, _ = cuda_ms(kern, n=100, warmup=2)
        p2, _ = cuda_ms(plain, n=10, warmup=2)
        ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        res[name] = (err, ms, p_ms)
        k_dev, p_dev = device_us(kern), device_us(plain)
        print(f"probe {name}: B={B} H={H}{f' K={K}' if name == 'micro_fused' else ''}"
              f", equal to its plain version (max abs err {err}); per call "
              f"(CUDA events) kernel {k1:.4f} / {k2:.4f} ms (means of 100), "
              f"plain {p1:.4f} / {p2:.4f} ms (means of 10); device time per "
              f"call (torch.profiler) kernel {k_dev:.3f} us, plain {p_dev:.3f}"
              f" us; ns_per_lane_step kernel {ms * 1e6 / lane_steps:.4f} "
              f"(device {k_dev * 1e3 / lane_steps:.4f}), plain "
              f"{p_ms * 1e6 / lane_steps:.4f} (device "
              f"{p_dev * 1e3 / lane_steps:.4f}) [{card}]", flush=True)

    # the probe scripts, each with its kernel's count read around it
    launches = {}
    for mod, counter in ((micro_pallas, hf.hot_fetch), (micro_fused, mf.micro_fused),
                         (micro_ablate, hf.hot_fetch)):
        name = mod.__name__.rsplit(".", 1)[1]
        counter.launches = 0
        t0 = time.perf_counter()
        mod.main()
        launches[name] = counter.launches
        if counter.launches < 1:
            raise RuntimeError(f"{name}.main() launched no kernel")
        print(f"probe script {name}: {counter.launches} launches, "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)

    src = "datok_tpu_torch/csrc/"
    rows = [("hot_fetch[select]", "hot_fetch.cu",
             "bench_micro/micro_pallas.py:58", launches["micro_pallas"]),
            ("micro_fused", "micro_fused.cu", "bench_micro/micro_fused.py:87",
             launches["micro_fused"]),
            ("hot_fetch[no_select]", "hot_fetch.cu",
             "bench_micro/micro_ablate.py:133", launches["micro_ablate"])]
    return [{"name": name, "route": "cuda", "source": src + source,
             "replaces": replaces, "launches": n,
             "max_abs_err": res[name][0], "ms": res[name][1],
             "plain_ms": res[name][2]} for name, source, replaces, n in rows]


def native_oracle(dtt, eng, text):
    """The native oracle over ``text`` as one lane, formatted by the
    native writer: the ground truth of every stream and file."""
    from datok_tpu.runtime.encode import text_to_codepoints
    from datok_tpu.utils.native import native_encode

    metas = native_encode(eng.encoder, text.encode("utf-8"))[1]
    ref = dtt.native_transduce_events(eng.tok, metas, as_array=True)
    if ref is None:
        raise RuntimeError("native oracle unavailable")
    w = dtt.NativeWriter(dtt.SIMPLE)
    w.feed(ref, text_to_codepoints(text))
    return w.getvalue()


def check_same(name, got, want):
    """Raise, naming the first differing character, unless equal."""
    if got != want:
        i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        raise RuntimeError(f"{name}: output differs from the native "
                           f"oracle at character {i}: {got[i - 40:i + 40]!r}"
                           f" vs {want[i - 40:i + 40]!r}")


def host_profile(run, label, sort, card, n=25):
    """``cProfile`` of one ``run()`` (from Python 3.12 on it sees every
    thread, so a pipelined run's prep and fetch threads too)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    print(f"profile: host time of {label}, by {sort} time [{card}]", flush=True)
    pstats.Stats(prof, stream=sys.stdout).sort_stats(sort).print_stats(n)


def stream_text(tok, synth_text):
    """Phase 7's ~32 MB stream: short documents ending in ``\\x04\\n``
    with the long EOT-free ones among them, cut from a pool of seeded
    synthetic text (generating 32 MB of it directly takes minutes)."""
    rng = np.random.default_rng(SEED + 5)
    # without the generator's own EOTs, so that documents keep their size
    pool = "".join(synth_text(tok, 64, 1 << 16, seed=SEED + 6)).replace("\x04", " ")
    n_docs, lo, hi = STREAM_DOCS
    n_long, llo, lhi = STREAM_LONG

    def cut(n):
        o = int(rng.integers(0, len(pool) - n))
        return pool[o:o + n]

    docs = [cut(int(n)) + "\x04\n" for n in rng.integers(lo, hi + 1, n_docs)]
    for i, n in zip(rng.choice(n_docs, n_long, replace=False),
                    rng.integers(llo, lhi + 1, n_long)):
        n = int(n)
        body = "".join(cut(min(n, 1 << 16)) for _ in range(n // (1 << 16) + 1))
        docs[i] = body[:n] + "\x04\n"
    return "".join(docs)


def stream_phase(dtt, kt, eng, card, synth_text, profile=False):
    """Phase 7: the stream through three surfaces, each byte-equal to
    the native oracle over the whole stream as one lane; ``profile``
    adds a host profile (cProfile) of one more ``tokenize_stream``.
    Returns the stream and its oracle output."""
    from datok_tpu_torch.runtime.machine import MAX_SEGMENT

    tok = eng.tok
    t0 = time.perf_counter()
    text = stream_text(tok, synth_text)
    data = text.encode("utf-8")
    long_docs = sum(len(d) > MAX_SEGMENT for d in text.split("\x04"))
    print(f"stream: {len(data)} bytes, {text.count(chr(4))} EOTs, {long_docs} "
          f"documents over MAX_SEGMENT, made in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    want = native_oracle(dtt, eng, text)
    print(f"stream: native oracle (one lane) {len(data) / (time.perf_counter() - t0) / 1e6:.2f}"
          " MB/s on the host", flush=True)

    surfaces = [
        ("tokenize_stream auto", lambda w: dtt.tokenize_stream(
            tok, text, w, engine=eng, long_strategy="auto")),
        ("tokenize_stream chained", lambda w: dtt.tokenize_stream(
            tok, text, w, engine=eng, long_strategy="chained")),
        ("tokenize_reader 4 MB chunks", lambda w: dtt.tokenize_reader(
            tok, io.BytesIO(data), w, engine=eng, chunk_bytes=4 << 20)),
    ]
    for name, run in surfaces:
        kt.transduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(dtt.NativeWriter(dtt.SIMPLE)).getvalue()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kt.transduce.launches
        if launches < 1:
            raise RuntimeError(f"{name}: K1 was not launched")
        check_same(name, got, want)
        print(f"stream {name}: {len(data) / wall / 1e6:.2f} MB/s ({len(data)} "
              f"bytes in {wall:.3f} s), K1 launches {launches}, byte-equal to "
              f"the native oracle [{card}]", flush=True)
    if profile:
        host_profile(lambda: surfaces[0][1](dtt.NativeWriter(dtt.SIMPLE)),
                     "one tokenize_stream (auto)", "cumulative", card)
    return text, want


STAGES = ("encode", "dispatch", "fetch", "decode", "format")


def stage_line(st, wall):
    """The pipeline's stage seconds (those it timed), their sum and the
    wall time."""
    keys = [k for k in STAGES if k in st]
    total = sum(st[k] for k in keys)
    stages = ", ".join(f"{k} {st[k]:.3f}" for k in keys)
    return (f"stages s: {stages}; sum {total:.3f} s vs wall {wall:.3f} s "
            f"(sum / wall {total / wall:.2f})")


def profile_overlap(run, n_bytes, card):
    """One pipelined run under ``torch.profiler``: the device-time table
    and the card's idle share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    print(avg.table(sort_by="self_device_time_total", row_limit=10), flush=True)
    device_s = sum(e.self_device_time_total for e in avg
                   if e.device_type == DeviceType.CUDA) / 1e6
    print(f"profile overlap: device time {device_s:.3f} s in a {wall:.3f} s "
          f"run ({n_bytes / wall / 1e6:.2f} MB/s under the profiler): card "
          f"idle {100 * (1 - device_s / wall):.1f}% [{card}]", flush=True)


def overlap_phase(dtt, kt, eng, card, wave_docs, stream7, profile=False):
    """Phase 8: (a) the phase-4 wave's texts as one stream of documents
    ending in ``\\x04\\n``, through ``tokenize_stream_pipelined`` (lanes=8192,
    pack_len=0, and the defaults) and the serial ``tokenize_stream``;
    (b) phase 7's stream through ``tokenize_stream_pipelined``.  Each
    output must equal the native oracle; returns K1's launches."""
    tok = eng.tok
    t0 = time.perf_counter()
    text_a = "".join(t + "\x04\n" for t in wave_docs)
    want_a = native_oracle(dtt, eng, text_a)
    print(f"overlap: stream (a) {len(text_a.encode('utf-8'))} bytes, "
          f"{len(wave_docs)} documents; its native oracle in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    text_b, want_b = stream7

    def pipelined(text, **kw):
        return lambda w, st: dtt.tokenize_stream_pipelined(
            tok, text, w, engine=eng, stats=st, **kw)

    runs = [
        ("(a) pipelined lanes=8192 pack_len=0", text_a, want_a,
         pipelined(text_a, lanes=8192, pack_len=0)),
        ("(a) pipelined defaults", text_a, want_a, pipelined(text_a)),
        ("(a) serial tokenize_stream", text_a, want_a,
         lambda w, st: dtt.tokenize_stream(tok, text_a, w, engine=eng)),
        ("(b) pipelined defaults, phase 7 stream", text_b, want_b,
         pipelined(text_b)),
    ]
    launches = 0
    for name, text, want, run in runs:
        n_bytes = len(text.encode("utf-8"))
        st = {}
        kt.transduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(dtt.NativeWriter(dtt.SIMPLE), st).getvalue()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kt.transduce.launches
        if n < 1:
            raise RuntimeError(f"overlap {name}: K1 was not launched")
        check_same(f"overlap {name}", got, want)
        launches += n
        line = f"; {stage_line(st, wall)}; stats {json.dumps(st)}" if st else ""
        print(f"overlap {name}: {n_bytes / wall / 1e6:.2f} MB/s ({n_bytes} "
              f"bytes in {wall:.3f} s), K1 launches {n}, byte-equal to the "
              f"native oracle{line} [{card}]", flush=True)
    if profile:
        from datok_tpu_torch.runtime import pipeline as P

        def run():
            return runs[1][3](dtt.NativeWriter(dtt.SIMPLE), {})

        profile_overlap(run, len(text_a.encode("utf-8")), card)
        host_profile(run, "one pipelined run of (a), defaults", "tottime", card)
        t0 = time.perf_counter()
        docs = P.split_stream(tok, text_a)
        t1 = time.perf_counter()
        P.predict_entries(eng.encoder, docs)
        t2 = time.perf_counter()
        print(f"profile: (a) alone on the host: split_stream {t1 - t0:.3f} s "
              f"({len(docs)} documents), predict_entries {t2 - t1:.3f} s "
              f"[{card}]", flush=True)
    return launches


def cut_mid_word(text):
    """``text`` without its final ``\\x04\\n``, cut inside its last word."""
    body = text[:-2]
    for i in range(len(body) - 1, 0, -1):
        if body[i].isalpha() and body[i - 1].isalpha():
            return body[:i]
    return body + "Wor"


def corpus_phase(dtt, kt, eng, card, wave_docs):
    """Phase 9: the synthetic model saved as a ``.matok``; 64 files cut
    from phase 8(a)'s documents (4 cut mid-word without EOT, 1 empty)
    through ``datok_tpu_torch.cli.main(["corpus", ...])``, each output
    equal to the native oracle; a second run must skip every file and
    launch nothing; ``python -m datok_tpu_torch.cli tokenize --batch``
    on one file in a subprocess must print the oracle's bytes.  Returns
    K1's launches of the first corpus run."""
    import contextlib
    import tempfile

    from datok_tpu_torch import cli

    n_files = 64
    per = len(wave_docs) // n_files
    texts = ["".join(t + "\x04\n" for t in wave_docs[i * per:(i + 1) * per])
             for i in range(n_files)]
    texts[7] = ""
    for i in (13, 29, 41, 58):
        texts[i] = cut_mid_word(texts[i])
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    with tempfile.TemporaryDirectory(prefix="datok-smoke-") as d:
        model = os.path.join(d, "synth.matok")
        eng.tok.save(model)
        files = []
        for i, t in enumerate(texts):
            files.append(os.path.join(d, f"doc{i:02d}.txt"))
            with open(files[-1], "w", encoding="utf-8") as f:
                f.write(t)
        out = os.path.join(d, "out")
        argv = ["corpus", "-t", model, "-o", out, *files, "--device",
                str(eng.device)]

        def corpus():
            buf = io.StringIO()
            kt.transduce.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"corpus: exit code {rc}")
            return json.loads(buf.getvalue().splitlines()[-1]), wall, \
                kt.transduce.launches

        stats, wall, launches = corpus()
        if launches < 1:
            raise RuntimeError("corpus: K1 was not launched")
        if (stats["done"], stats["skipped"]) != (n_files, 0):
            raise RuntimeError(f"corpus: {stats}")
        t0 = time.perf_counter()
        for f, t in zip(files, texts):
            with open(os.path.join(out, os.path.basename(f) + ".tok"),
                      encoding="utf-8") as fh:
                check_same(f"corpus {os.path.basename(f)}", fh.read(),
                           native_oracle(dtt, eng, t))
        print(f"corpus: {json.dumps(stats)}", flush=True)
        print(f"corpus: {n_files} files, {n_bytes} bytes in {wall:.3f} s, "
              f"{n_bytes / wall / 1e6:.2f} MB/s; K1 launches {launches}; "
              f"{stage_line(stats['pipeline'], wall)}; every output "
              f"byte-equal to the native oracle (checked in "
              f"{time.perf_counter() - t0:.2f} s) [{card}]", flush=True)

        again, wall2, launches2 = corpus()
        if (again["done"], again["skipped"]) != (0, n_files) or launches2:
            raise RuntimeError(f"corpus resume: {again}, K1 launches "
                               f"{launches2}")
        print(f"corpus resume: skipped all {n_files} files in {wall2:.3f} s, "
              f"K1 launches {launches2}", flush=True)

        pick = files[13]
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "datok_tpu_torch.cli", "tokenize", "-t",
             model, pick, "--batch", "--device", str(eng.device)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"cli tokenize --batch: exit code "
                               f"{r.returncode}: {r.stderr.decode()[-2000:]}")
        check_same("cli tokenize --batch", r.stdout.decode("utf-8"),
                   native_oracle(dtt, eng, texts[13]))
        print(f"cli: python -m datok_tpu_torch.cli tokenize --batch --device "
              f"{eng.device} on {os.path.basename(pick)} ({len(texts[13])} "
              f"characters, ends mid-word): stdout byte-equal to the native "
              f"oracle, {time.perf_counter() - t0:.2f} s with start-up "
              f"[{card}]", flush=True)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="break the phase-4 wave down by stage and profile "
                         "one stream on the host")
    opts = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    import datok_tpu_torch as dtt
    from datok_tpu_torch.kernels import build
    from datok_tpu_torch.kernels import transduce as kt
    from datok_tpu_torch.runtime.machine import run_machine
    from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer

    # 2. build: K1, KF and KP at once, one nvcc each
    t0 = time.perf_counter()
    build_s = build.build_all(build.CUDA_LIBS)
    for spec in build.CUDA_LIBS:
        build.load(spec)
    print(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in build_s.items())}"
          f" (in parallel; {time.perf_counter() - t0:.2f} s with loading)",
          flush=True)
    for spec in build.CUDA_LIBS:
        if os.path.exists(spec.log):
            for line in open(spec.log):
                if "registers" in line or "spill" in line:
                    print(f"build: {spec.name}:", line.strip(), flush=True)

    # 3. kernel vs plain on the same CUDA tensors
    t0 = time.perf_counter()
    tok = synth_tokenizer(seed=SEED)
    eng = dtt.BatchEngine(tok, device="cuda")
    print(f"model: synthetic, {tok.state_count} states x "
          f"{eng.tables.max_sym} symbols, {4 * eng.tables.n_cells / 1e6:.2f} MB, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    B3, L3 = CHECK_SHAPE
    rng = np.random.default_rng(SEED)
    lens3 = rng.integers(L3 // 4, L3 + 1, B3)
    lens3[0] = L3
    texts3 = synth_text(tok, B3, [int(x) for x in lens3], seed=SEED + 3)
    meta3, lengths3, _ = eng.encoder.encode_batch(texts3)
    stops3 = rng.random(B3) < 0.125
    max_steps3 = eng.max_steps_for(meta3.shape[1])
    first = run_machine(eng.tables, *to_cuda(meta3, lengths3, None, stops3),
                        max_steps3)
    # non-root entries: the exit contexts of that run, shuffled
    entries3 = first[3][:, 0].cpu().numpy()[rng.permutation(B3)]
    args3 = (eng.tables, *to_cuda(meta3, lengths3, entries3, stops3), max_steps3)
    err3 = max_abs_err(kt.transduce(*args3), run_machine(*args3))
    if err3 != 0:
        raise RuntimeError(f"K1 differs from the plain machine (max abs err {err3})")
    # in turns: plain, kernel, kernel, plain (K1 turns: mean of 10)
    p1, _ = cuda_ms(lambda: run_machine(*args3))
    k1, _ = cuda_ms(lambda: kt.transduce(*args3), n=10, warmup=2)
    k2, _ = cuda_ms(lambda: kt.transduce(*args3), n=10, warmup=2)
    p2, _ = cuda_ms(lambda: run_machine(*args3))
    print(f"kernel vs plain: B={B3} x L={L3}, events/counts/bad/state/steps "
          f"equal (max abs err {err3}); K1 {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms [{card}]", flush=True)

    # 4. main path at real size
    texts = wave_texts(tok, *WAVE_SHAPE, synth_text)
    launches, err4, k_ms, p_ms = run_wave(dtt, kt, run_machine, eng, texts,
                                          card, "synthetic DE-size model")
    if opts.profile:
        profile_wave(dtt, kt, eng, texts, card)

    # 5. the DE model, if present
    if DE_MODEL and os.path.exists(DE_MODEL):
        tok_de = dtt.load_tokenizer_file(DE_MODEL)
        eng_de = dtt.BatchEngine(tok_de, device="cuda")
        B, L = WAVE_SHAPE
        run_wave(dtt, kt, run_machine, eng_de,
                 [bench_lane(i, L) for i in range(B)], card, "DE model")
    else:
        print("DE model: skipped, DATOK_DE_MODEL names no file", flush=True)

    # 6. the probe kernels and their scripts
    probes = probe_phase(card, torch.device("cuda"))

    # 7. streaming at real size
    stream7 = stream_phase(dtt, kt, eng, card, synth_text, opts.profile)

    # 8. the overlapped pipeline, on phase 4's texts and phase 7's stream
    launches8 = overlap_phase(dtt, kt, eng, card, texts, stream7, opts.profile)

    # 9. the corpus runner and the CLI
    launches9 = corpus_phase(dtt, kt, eng, card, texts)
    print(f"K1 launches by path: phase 4 wave {launches}, phase 8 "
          f"{launches8}, phase 9 corpus {launches9}", flush=True)

    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "transduce",
        "route": "cuda",
        "source": "datok_tpu_torch/csrc/transduce.cu",
        "replaces": "datok_tpu/runtime/pallas_engine.py:384",
        "launches": launches + launches8 + launches9,
        "max_abs_err": max(err3, err4),
        "ms": k_ms,
        "plain_ms": p_ms,
    }] + probes}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
