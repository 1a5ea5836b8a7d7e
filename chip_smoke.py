"""Smoke run of the PyTorch port (datok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure raises and the script exits nonzero:

1. device: needs CUDA; prints the card's name and power limit;
2. build: builds K1 (csrc/transduce.cu), KF and KP from the
   repository's sources, all at once, one ``nvcc`` each, and counts
   the fewest instructions one pass of K1's step loop issues in its
   SASS (``cuobjdump``), for each instantiation: the full form (run
   skip and fused boundaries; the engine's) and the general form, over
   the matrix and over a double array;
3. kernel vs plain: K1 and the plain PyTorch machine on the same CUDA
   tensors (full-size synthetic model, B=4096 x L=256, without a hot
   set and with the ``"auto"`` one), each in both forms, must agree
   exactly, cold-step counts included; both are timed in turns (plain,
   kernel, kernel, plain);
4. main path: one wave of B=32768 x L=1024 through
   ``BatchEngine(tok, device="cuda").events_batch`` and the native
   writer; K1 must have launched, every lane must equal the native
   oracle, and 64 sampled lanes must be byte-equal to ``tok.tokenize``;
   then K1 and the plain machine run the wave's own tensors, must agree
   exactly and are timed in turns, and K1 with no hot set (the
   default, ``hot_size=0``) and with the ``"auto"`` one in turns, on
   the wave and on one of its shape whose lanes all read the same text;
   then K1's general and full forms: equal on every lane both finish,
   the full form never taking more steps, then in turns (general, full,
   full, general), with each form's steps a character, instructions a
   step and bound; the main path must not have launched the general
   form;
4b. the double array: the DE-size ``synth_datok`` (phase 4's model as
   base/check, about 3.05 M cells) on K1's general form over its
   (word, check) pairs and hop table (the time to build them on the
   host and the hop table's size are printed):
   (a) K1 and the plain machine on phase 3's shape with entries and
   stops, equal on every quantity; (b) phase 4's wave through
   ``BatchEngine(da, device="cuda", engine="general").events_batch`` and
   the native writer, which must launch the double-array form and only
   it, every lane equal in events, counts, steps, backtracks, forced
   emits and bytes to the matrix engine under ``engine="general"``, the
   bytes equal to phase 4's, and K1 equal to the plain machine on 1024
   of its lanes and on all of them (timed in turns), with the share of
   the plain machine's successful steps that take a separate-state
   hop; (c) ``"auto"`` on
   a double array whose ``to_matrix()`` raises must warn and run on the
   card; (d) the double-array form, the matrix general form and the
   matrix full form in turns, with steps a character, each warp's
   slowest lane, instructions a step and the bound, and the
   double-array form with its hop table spread over one entry a state
   (a real model's largest, its hops dealt out over the copies), equal
   to the plain machine and timed in turns with the table as built; (e)
   phase 8(a)'s stream once through ``tokenize_stream_pipelined`` on
   the double-array engine, byte-equal to the native oracle;
5. the DE model, when ``DATOK_DE_MODEL`` names its ``.matok`` file,
   through the same path;
6. the probe kernels: KF (``csrc/hot_fetch.cu``, prepared once, select
   on and off) and KP (``csrc/micro_fused.cu``) in both forms (H=384:
   the planes in shared memory; H=512: in L2) at the TPU probes'
   default size (B=16384, K=64) on the probes' seeded inputs plus
   out-of-range lanes must equal their plain versions exactly; each is
   timed in turns (per call by CUDA events, device time by
   ``torch.profiler``), KF beside a ``torch.take`` that gives the same
   values; KP's shared-memory form also at B=200,000 (untimed), where
   its threads loop over further lanes and refill their ring window;
   then the three probe scripts (``datok_tpu_torch.bench_micro``) run
   once each, and each must have launched its kernel (the fetch scripts
   time their chains as CUDA-graph replays beside the eager chains, and
   count the KF launches the replays ran from the graph's nodes);
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
   wall time; then, untimed, (a) with the defaults on an engine with
   the ``"auto"`` hot set, whose first wave, as the pipeline launched
   it (B=8192 x L=2048), runs through K1 with ``hot_size=0`` and
   ``"auto"`` in turns, and through K1's two forms as in phase 4;
9. the corpus runner and the CLI: the model saved as a ``.matok``, 64
   files cut from phase 8's documents (4 ending mid-word without EOT,
   1 empty) through ``datok_tpu_torch.cli.main(["corpus", ...])``, each
   output byte-equal to the native oracle; a second run must skip all
   64 files and launch K1 zero times; and ``python -m
   datok_tpu_torch.cli tokenize --batch --device cuda`` on one file in a
   subprocess must print the oracle's bytes;
10. the sharded engine (``parallel/mesh.py``) over every card, or over
   ``cuda:0`` twice when there is one (then it measures the sharded
   launch path, not scaling): (a) phase 4's wave through
   ``ShardedEngine.events_batch``, every lane equal to phase 4's, one K1
   launch a shard, ``corpus_stats`` equal to the counters of the single
   engine's events, ``events_batch`` and the launch timed in turns
   against the single engine, and each shard's K1 between CUDA events
   on its stream (did shards sharing a card overlap); (b) phase 8(a)'s stream through
   ``tokenize_stream_pipelined`` on it, in turns with the single
   engine, byte-equal to the native oracle; (c) two processes over gloo
   (``parallel/distributed.py``), each on ``cuda:{rank % device_count}``,
   through ``run_corpus_distributed`` on phase 9's 64 files after a
   warm-up run: outputs byte-equal to phase 9's, the summed counters
   equal to phase 9's, and a second run skipping every file with no K1
   launch;
11. hot sets (the profiled sets of phases 3-8 stay fixed,
   ``per_wave=False``): (a) phase 4's wave through
   ``BatchEngine(tok, hot_size="auto", per_wave=True)``, every lane and
   the bytes equal to phase 4's, with the census's ms (host), the
   tagging's ms (CUDA events), the rung, the set's size and
   ``last_cold_share``, then K1 in turns (means of 10) with no hot set,
   the profiled ``"auto"`` set, the wave's own set and the wave's sets
   at the ladder's rungs; (b) phase 8(a)'s stream through
   ``tokenize_stream_pipelined`` on that engine (defaults), byte-equal
   to the native oracle, with ``stats["census"] > 0`` and at least two
   distinct wave sets launched (else phase 7's stream must show them),
   its first wave's K1 in turns as in (a), and ``pipelined_mbps`` in
   turns with ``per_wave=False`` on the same profiled set and with
   ``hot_size=0``, each engine's K1 launches counted from its own runs
   (at least one a wave); (c) ``AdaptiveEngine`` with a narrow set of
   ``ADAPTIVE_NARROW`` states on an in-profile and a rare-word-dense
   wave of phase 4's shape: the cold rates and choices (one wave each
   way), ``cold_rate``'s ms a call, the narrow and wide engines and the
   router's ``events_batch`` (on the engine it chose) equal to the
   default one on every lane and byte, each with its own launch count;
   (d) ``BatchEngine(tok, engine="hot")`` on phase
   4's wave, equal to phase 4's bytes, K1 in turns against the default
   engine;
12. the port's benchmark (``datok_tpu_torch.bench``) in this process at
   phase 4's shape, each row three timed runs after two warm-ups: uniform,
   hetero, mixed, novel, the double array through ``"auto"`` and
   ``engine="general"``, e2e, the pipelined stream at 8 MB and the
   corpus on 16 files; every row's lanes, streams and files equal to
   the native oracle, each row with its own K1 launches; its JSON line
   is printed.

``--profile`` adds a breakdown of the phase-4 wave after phase 4: each
stage timed on the host clock between ``torch.cuda.synchronize()``
calls (three repetitions after a warm-up), ``events_batch`` alone, and
a ``torch.profiler`` table of one ``events_batch`` with the card's idle
share; and after phase 7 a ``cProfile`` table of one more
``tokenize_stream``; and after phase 8, for one pipelined run, a
``torch.profiler`` table with the card's idle share and a ``cProfile``
table of all its threads, and the host time of the EOT split and the
entry prediction alone.

Phases 4, 7 and 8 print the share of K1's steps whose state was cold
with the ``"auto"`` hot set (``BatchEngine.cold_share``; phase 7 from
one more, untimed ``tokenize_stream`` on that engine).  The script
fails if the port loaded jax or any module of the JAX package.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches on its paths (K1: phase 4's wave,
phase 8's timed runs, phase 9's first corpus run, phase 10's sharded
runs, the two ranks' included, phase 11's (a)-(d) and phase 12's rows
but the double array's; KF and KP: their probe scripts), its
largest error against the plain version, both times at its path's shape, its bound (the larger of its bytes over
3.35 TB/s and, for K1, its instructions over the card's issue rate,
from this run's inputs) and the time of one PyTorch call computing the
same function, where there is one; K1's entry adds its time with the
``"auto"`` hot set and that set's size, its time with one text on every
lane, the cold shares, its two forms' turns, steps a character,
instructions a step and bounds on the waves of phases 4 and 8
(``forms``), each instantiation's instructions a step (``step_instr``),
phase 10's numbers and phase 4b's (``da``: the double-array form's
launches in that phase, its time, plain time, bound and instructions a
step, the hop table's size and hop share, the pairs' build time and
the spread table's time) and phase 11's (``phase11``: each path's
launches, read from that path's runs alone, times, cold shares and
rates) and phase 12's (``phase12``: each row's launches and MB/s);
KF's and KP's add their device time a call,
KF's the per-step times of its driver's chain as graph replays and
eager, the launches those replays ran (``graph_launches``, beside
``launches``, the wrapper's own count) and, with the select on, the
``torch.take`` time, and KP's its L2 form's numbers and the check of
its persistent form.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from datok_tpu_torch.bench import (SEED, STREAM_DOCS, STREAM_LONG, STREAM_POOL,
                                   bench_lane, check_same,
                                   corpus_texts, format_wave, native_oracle,
                                   stream_text, wave_texts)
from datok_tpu_torch.kernels.sass import (ISSUE_PER_SM_CLOCK, bound_ms,
                                          k1_bound, k1_kernel)

# the reference DE model (tokenizer_de.matok) is not in the repository;
# phase 5 runs when this variable names it
DE_MODEL = os.environ.get("DATOK_DE_MODEL", "")
CHECK_SHAPE = (4096, 256)  # (B, L) of the kernel-vs-plain phase
WAVE_SHAPE = (32768, 1024)  # (B, L) of the main-path wave, bench.py:400-401
PROBE_SHAPE = (16384, 384, 64)  # (B, H, K) defaults of the TPU probes
PROBE_H_L2 = 512  # KP's planes too large for shared memory: its L2 form
# lanes at which KP's 256-thread blocks loop over further lanes and hold
# fewer than K of the steps' ring words at once
PROBE_B_LOOP = 200_000
N_SYMBOLS = 256  # rows of KF's planes
# phase 11(c): the adaptive router's narrow set (states) and its two
# samples, the texts of tests/test_adaptive.py:18-34 (in-profile prose:
# the calibration text, which the profiled set is built from; and
# rare-word-dense text).  At 288 states their cold rates lie on either
# side of the threshold, so one wave routes narrow and the other wide.
ADAPTIVE_NARROW = 288
COLD_HEAVY = (
    "Erreichbar via https://korap.ids-mannheim.de/?q=Baum&x=1 oder "
    "korap[at]ids-mannheim[dot]de bzw. 10.0.10.51:8080. Vgl. "
    "F.D.P.-Fraktion, Ba.-Wü., z.Zt. ca. 0,5% lt. Prof. Dr.-Ing. "
    "Musterfrau-Häberle. ;-) ^_^ &#x2F; <a href='x.htm'>T</a> "
) * 8


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


def k1_turns(args, tb_hot, tb_none, n=10):
    """K1 with no hot set and with the engine's, in turns (none, auto,
    auto, none), each the mean of ``n`` launches after a warm-up, on
    the same inputs; both must give the same results."""
    from datok_tpu_torch.kernels import transduce as kt

    _tb, *rest = args
    a = kt.transduce(tb_none, *rest)
    b = kt.transduce(tb_hot, *rest)
    err = max_abs_err(a[:5], b[:5])
    if err:
        raise RuntimeError(f"K1 differs between hot sets (max abs err {err})")
    z1, _ = cuda_ms(lambda: kt.transduce(tb_none, *rest), n=n, warmup=2)
    h1, _ = cuda_ms(lambda: kt.transduce(tb_hot, *rest), n=n, warmup=2)
    h2, _ = cuda_ms(lambda: kt.transduce(tb_hot, *rest), n=n, warmup=2)
    z2, _ = cuda_ms(lambda: kt.transduce(tb_none, *rest), n=n, warmup=2)
    share = b[5][0].item() / max(b[5][1].item(), 1)
    return (z1, h1, h2, z2), share


def form_turns(args, label, chip, card, n_states, n=10):
    """K1's general and full forms on the same inputs: the lanes that
    finish in both must give the same events, counts and exit rows, and
    the full form no more steps on any of them; then both in turns
    (general, full, full, general), each the mean of ``n`` launches
    after a warm-up, the steps a character of each, and each form's
    bound from its steps and its step loop's instructions (the
    ``n_states`` states whose rows the walk reads, and for the full form
    the per-state words).  Returns the numbers for the ``kernels`` line."""
    from datok_tpu_torch.kernels import transduce as kt

    tb, meta, lengths, *_ = args
    res = {"general": kt.transduce_general(*args), "full": kt.transduce(*args)}
    (ev_g, c_g, bad_g, st_g, steps_g, _), (ev_f, c_f, bad_f, st_f, steps_f,
                                            _) = res.values()
    done = ~bad_g & ~bad_f
    keep = torch.arange(ev_g.shape[1], device=ev_g.device)[None, :] < c_g[:, None]
    same = (torch.equal(c_g[done], c_f[done])
            and torch.equal(st_g[done], st_f[done])
            and torch.equal(torch.where(keep, ev_g, 0)[done],
                            torch.where(keep, ev_f, 0)[done]))
    if not same or bool((bad_f & ~bad_g).any()) or bool(
            (steps_f[done] > steps_g[done]).any()):
        raise RuntimeError(f"{label}: K1's full form differs from its "
                           "general form on a lane both finish, or takes "
                           "more steps")
    g1, _ = cuda_ms(lambda: kt.transduce_general(*args), n=n, warmup=2)
    f1, _ = cuda_ms(lambda: kt.transduce(*args), n=n, warmup=2)
    f2, _ = cuda_ms(lambda: kt.transduce(*args), n=n, warmup=2)
    g2, _ = cuda_ms(lambda: kt.transduce_general(*args), n=n, warmup=2)
    n_chars = max(int(lengths.long().sum()), 1)
    out = {"B": int(meta.shape[0]), "L": int(meta.shape[1]),
           "lanes_done_in_both": int(done.sum()), "turns_ms": [g1, f1, f2, g2]}
    for form, ms in (("general", (g1 + g2) / 2), ("full", (f1 + f2) / 2)):
        r = res[form]
        kern = k1_kernel(int(meta.shape[0]), chip["n_sm"], form)
        instr = chip["step_instr"][kern]
        words = tb.state_bits.numel() if form == "full" else 0
        bound, by, n_b, b_ms, n_steps, ops_ms = k1_bound(
            args[1:5], r, n_states, instr, chip["n_sm"], chip["clock_hz"],
            words)
        # K1's time follows each warp's slowest lane
        out[form] = {"ms": ms, "steps": n_steps,
                     "steps_per_char": n_steps / n_chars,
                     "warp_max_steps_mean": warp_max_steps(r[4]),
                     "max_lane_steps": int(r[4].max()),
                     "bad_lanes": int(r[2].sum()), "kernel": kern,
                     "step_instr": instr, "bound_ms": bound, "bound_by": by,
                     "bytes": n_b, "bytes_ms": b_ms, "instr_ms": ops_ms}
        print(f"{label}: K1 {form} form: {n_steps} steps, "
              f"{n_steps / n_chars:.4f} steps/char, a warp's slowest lane "
              f"{out[form]['warp_max_steps_mean']:.1f} steps on average, the "
              f"slowest {out[form]['max_lane_steps']}, {instr} instructions a "
              f"step ({kern}); bound {bound:.4f} ms by {by} (instructions "
              f"{ops_ms:.4f} ms, bytes {n_b} = {b_ms:.4f} ms); mean "
              f"{ms:.4f} ms, {ms / bound:.2f}x its bound [{card}]",
              flush=True)
    print(f"{label}: K1 in turns, B={out['B']} x L={out['L']}, general / "
          f"full / full / general: {g1:.4f} / {f1:.4f} / {f2:.4f} / "
          f"{g2:.4f} ms (means of {n}); equal on the {out['lanes_done_in_both']}"
          f" lanes both finish; full / general "
          f"{out['full']['ms'] / out['general']['ms']:.3f} [{card}]",
          flush=True)
    return out


def to_cuda(meta, lengths, entries=None, stops=None):
    B = meta.shape[0]
    dev = torch.device("cuda")
    if entries is None:
        entries = np.ones(B, np.int32)
    if stops is None:
        stops = np.zeros(B, bool)
    return (torch.from_numpy(meta).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(np.asarray(entries, np.int32)).to(dev),
            torch.from_numpy(np.asarray(stops, bool)).to(dev))


def run_wave(dtt, run_machine, eng, eng_hot, texts, card, label, chip):
    """One wave through the main path (events_batch on ``eng``, which
    has no hot set, then the native writer), checked lane by lane, then
    K1 against the plain machine on the wave's tensors and K1 without
    and with ``eng_hot``'s hot set in turns; ``chip`` holds the SMs,
    the top clock and the step loop's instructions for the bound.
    Returns a dict of K1's launches on the main path, max abs err, its
    times, the plain time, the bound, the hot set's cold share and the
    main path's events of each lane (``evs``)."""
    from datok_tpu_torch.kernels import transduce as kt
    from datok_tpu_torch.utils.native import native_state_census

    tok = eng.tok
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    torch.cuda.synchronize()
    eng.reset_cold()
    kt.transduce.launches = kt.transduce_general.launches = 0
    t0 = time.perf_counter()
    evs = eng.events_batch(texts, as_arrays=True)
    out = format_wave(texts, evs)
    wall = time.perf_counter() - t0
    launches = kt.transduce.launches
    if launches < 1:
        raise RuntimeError("the main path did not launch K1")
    if kt.transduce_general.launches:
        raise RuntimeError("the main path launched K1's general form")
    if not out:
        raise RuntimeError("the main path formatted no output")
    print(f"{label}: main path {n_bytes / wall / 1e6:.2f} MB/s "
          f"({n_bytes} bytes in {wall:.3f} s, encode+K1+decode+format), "
          f"K1 launches {launches}; hot set {eng.hot_size} states "
          f"[{card}]", flush=True)

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

    # every lane against the native oracle; the states whose rows the
    # walk reads, from the native census of each lane
    seen = np.zeros(tok.state_count + 1, dtype=bool)
    for i in range(len(texts)):
        ref = dtt.native_transduce_events(tok, meta[i, : lengths[i]], as_array=True)
        if ref is None:
            raise RuntimeError("native oracle unavailable")
        if not np.array_equal(ref, evs[i]):
            raise RuntimeError(f"{label}: lane {i} differs from the native "
                               f"oracle: {texts[i][:80]!r}")
        seen |= native_state_census(tok, meta[i, : lengths[i]])[0] > 0
    rng = np.random.default_rng(SEED + 2)
    for i in rng.choice(len(texts), 64, replace=False):
        got = dtt.format_events(evs[i], texts[i], dtt.SIMPLE)
        if got != tok.tokenize(texts[i]):
            raise RuntimeError(f"{label}: lane {i} bytes differ from "
                               f"tok.tokenize: {texts[i][:80]!r}")
    print(f"{label}: all {len(texts)} lanes equal the native oracle, "
          "64 sampled lanes byte-equal to tok.tokenize", flush=True)
    (z1, h1, h2, z2), share = k1_turns(args, eng_hot.tables, eng.tables)
    kern = k1_kernel(meta.shape[0], chip["n_sm"])
    step_instr = chip["step_instr"][kern]
    bound, by, n_b, b_ms, n_steps, ops_ms = k1_bound(
        args[1:5], res, int(seen.sum()), step_instr, chip["n_sm"],
        chip["clock_hz"], eng.tables.state_bits.numel())
    print(f"{label}: K1 in turns on the wave, hot_size=0 / auto "
          f"({eng_hot.hot_size}) / auto / 0: {z1:.4f} / {h1:.4f} / "
          f"{h2:.4f} / {z2:.4f} ms (means of 10); cold share of the auto "
          f"launch {share:.6f} [{card}]", flush=True)
    print(f"{label}: K1 bound {bound:.4f} ms, by {by}: bytes {n_b} "
          f"({int(seen.sum())} states read) at 3.35 TB/s = {b_ms:.4f} ms; "
          f"{n_steps} steps x {step_instr} instructions ({kern}) at "
          f"{ISSUE_PER_SM_CLOCK} a clock on {chip['n_sm']} SMs at "
          f"{chip['clock_hz'] / 1e6:.0f} MHz = {ops_ms:.4f} ms [{card}]",
          flush=True)
    # the same shape with one text on every lane: no lane of a warp
    # branches apart from another, which shows what divergence costs
    meta_u, lengths_u, _ = eng.encoder.encode_batch(
        [bench_lane(0, meta.shape[1])] * len(texts))
    args_u = (eng.tables, *to_cuda(meta_u, lengths_u),
              eng.max_steps_for(meta_u.shape[1]))
    (u1, uh1, uh2, u2), _ = k1_turns(args_u, eng_hot.tables, eng.tables)
    print(f"{label}: K1 in turns with one text on every lane, hot_size=0 /"
          f" auto / auto / 0: {u1:.4f} / {uh1:.4f} / {uh2:.4f} / {u2:.4f} "
          f"ms (means of 10) [{card}]", flush=True)
    forms = form_turns(args, label, chip, card, int(seen.sum()))
    return {"launches": launches, "err": err, "ms": ms, "evs": evs,
            "out": out, "forms": forms, "seen": int(seen.sum()),
            "ms_auto": (h1 + h2) / 2, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": by, "cold_share": share,
            "ms_same_text": (u1 + u2) / 2, "ms_same_text_auto": (uh1 + uh2) / 2}


def lanes_equal(a, b, label):
    """Raise unless two machine results agree on every lane in events
    (masked by their counts), counts, ``bad``, steps, backtracks and
    forced emits: what two layouts of one model share (their states
    are numbered apart)."""
    same = (torch.equal(masked(a[0], a[1]), masked(b[0], b[1]))
            and all(torch.equal(x, y) for x, y in
                    ((a[1], b[1]), (a[2], b[2]), (a[4], b[4]),
                     (a[3][:, 2:], b[3][:, 2:]))))
    if not same:
        raise RuntimeError(f"{label}: the double array's lanes differ from "
                           "the matrix's")


def warp_max_steps(steps):
    """Each warp's slowest lane (32 lanes a warp), as a mean."""
    lane = steps.long()
    pad = (-lane.numel()) % 32
    return float(torch.cat([lane, lane.new_zeros(pad)]).view(-1, 32)
                 .amax(1).float().mean())


def da_phase(dtt, kt, run_machine, eng, texts, texts3, w4, card, chip):
    """Phase 4b: the DE-size double array (``synth_datok``, the twin of
    phase 4's model) on K1's general form over base/check.  (a) K1
    against the plain machine on phase 3's shape with entries and
    stops; (b) phase 4's wave through ``BatchEngine(da,
    engine="general").events_batch`` and the native writer, equal on
    every lane to the matrix engine under ``engine="general"`` and to
    phase 4's bytes, then K1 against the plain machine on the wave's
    tensors, in turns; (c) ``"auto"`` on a double array whose
    conversion fails; (d) the double-array form, the matrix general
    form and the matrix full form in turns, with steps a character,
    instructions a step and the bound, and the double-array form with a
    spread hop table; (e) phase 8(a)'s stream pipelined on the
    double-array engine.  Returns the ``da`` block of the ``kernels``
    line, stream (a) with its native oracle output, and the double
    array."""
    from datok_tpu_torch.fsa.double_array import DaTokenizer
    from datok_tpu_torch.runtime.rep import da_pairs, tables_from_tokenizer
    from datok_tpu_torch.testing.synth import DE_N_ABBREV, synth_datok

    t0 = time.perf_counter()
    da = synth_datok(DE_N_ABBREV, SEED)
    built = time.perf_counter() - t0
    eng_da = dtt.BatchEngine(da, device="cuda", engine="general")
    tb = eng_da.tables
    if eng_da.engine != "general" or tb.kind != "DATOK":
        raise RuntimeError("engine='general' did not keep the double array")
    sep = int((np.asarray(da.base, np.uint32) >> 31).sum())
    print(f"da: synthetic DE-size double array, {tb.n_cells} base/check "
          f"cells ({8 * tb.n_cells / 1e6:.2f} MB), {sep} separate-state "
          f"slots, size {tb.size}, built in {built:.2f} s", flush=True)
    # K1's form of the cells: the (word, check) pairs and the hop table
    t0 = time.perf_counter()
    _, hop_np = da_pairs(da.base, da.check)
    pairs_s = time.perf_counter() - t0
    n_hop = hop_np.shape[0]
    print(f"da: the pair array ({8 * tb.n_cells} bytes) and the hop table "
          f"({n_hop} representatives, {8 * n_hop} bytes, read through L1) "
          f"built on the host in {pairs_s:.3f} s", flush=True)

    # (a) K1 against the plain machine, phase 3's shape, entries and stops
    B3, L3 = CHECK_SHAPE
    meta3, lengths3, _ = eng_da.encoder.encode_batch(texts3)
    rng = np.random.default_rng(SEED + 7)
    stops3 = rng.random(B3) < 0.125
    ms3 = eng_da.max_steps_for(meta3.shape[1])
    first = run_machine(tb, *to_cuda(meta3, lengths3, None, stops3), ms3,
                        form="general")
    # non-root entries: that run's exit contexts (slot ids), shuffled
    entries3 = first[3][:, 0].cpu().numpy()[rng.permutation(B3)]
    args3 = (tb, *to_cuda(meta3, lengths3, entries3, stops3), ms3)
    err_a = max_abs_err(kt.transduce_general(*args3),
                        run_machine(*args3, form="general"))
    if err_a != 0:
        raise RuntimeError(f"da (a): K1's double-array form differs from "
                           f"the plain machine (max abs err {err_a})")
    print(f"da (a): kernel vs plain, B={B3} x L={L3} with entries and "
          f"stops: events/counts/bad/state/steps/cold equal (max abs err "
          f"{err_a}) [{card}]", flush=True)

    # (b) the main path
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    torch.cuda.synchronize()
    kt.transduce.launches = kt.transduce_general.launches = 0
    t0 = time.perf_counter()
    evs = eng_da.events_batch(texts, as_arrays=True)
    out = format_wave(texts, evs)
    wall = time.perf_counter() - t0
    launches_b = kt.transduce_general.launches
    if launches_b < 1:
        raise RuntimeError("da (b): the main path did not launch K1's "
                           "double-array form")
    if kt.transduce.launches:
        raise RuntimeError("da (b): a general engine launched the full form")
    check_same("da (b) main path", out, w4["out"])
    eng_mg = dtt.BatchEngine(eng.tok, device="cuda", engine="general")
    evs_mg = eng_mg.events_batch(texts, as_arrays=True)
    for i, (x, y) in enumerate(zip(evs, evs_mg)):
        if not np.array_equal(x, y):
            raise RuntimeError(f"da (b): lane {i} differs from the matrix "
                               f"engine: {texts[i][:80]!r}")
    check_same("da (b) matrix engine, general", format_wave(texts, evs_mg),
               out)
    meta, lengths, _ = eng_da.encoder.encode_batch(texts)
    meta_m, lengths_m, _ = eng_mg.encoder.encode_batch(texts)
    steps_w = eng_da.max_steps_for(meta.shape[1])
    args = (tb, *to_cuda(meta, lengths), steps_w)
    args_mg = (eng_mg.tables, *to_cuda(meta_m, lengths_m), steps_w)
    res = kt.transduce_general(*args)
    lanes_equal(res, kt.transduce_general(*args_mg), "da (b)")
    print(f"da (b): main path {n_bytes / wall / 1e6:.2f} MB/s ({n_bytes} "
          f"bytes in {wall:.3f} s, encode+K1+decode+format), K1 "
          f"double-array launches {launches_b}; every lane's events, "
          "counts, steps, backtracks and forced emits equal to the matrix "
          "engine's (engine='general'), the bytes equal to phase 4's "
          f"[{card}]", flush=True)
    # against the plain machine on 1024 of the wave's lanes, then on all
    sl = tuple(x[:1024] for x in args[1:5])
    plain_sl = run_machine(tb, *sl, steps_w, form="general")
    err_b = max_abs_err(kt.transduce_general(tb, *sl, steps_w), plain_sl)
    if err_b != 0:
        raise RuntimeError(f"da (b): K1 differs from the plain machine on "
                           f"1024 lanes of the wave (max abs err {err_b})")
    # the plain machine counts the successful steps and their hops
    hop_count = torch.zeros(2, dtype=torch.int64, device=args[1].device)
    plain = run_machine(*args, form="general", hop_count=hop_count)
    n_succ, n_hops = (int(x) for x in hop_count.cpu())
    err_b = max(err_b, max_abs_err(res, plain))
    if err_b != 0:
        raise RuntimeError(f"da (b): K1 differs from the plain machine on "
                           f"the wave (max abs err {err_b})")
    print(f"da (b): the plain machine on the wave: {n_succ} successful "
          f"steps, {n_hops} of them through a separate-state hop (share "
          f"{n_hops / max(n_succ, 1):.4f})", flush=True)
    # in turns: plain, kernel, kernel, plain on the whole wave
    p1, _ = cuda_ms(lambda: run_machine(*args, form="general"))
    k1, _ = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    k2, _ = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    p2, _ = cuda_ms(lambda: run_machine(*args, form="general"))
    print(f"da (b): kernel vs plain on 1024 lanes of the wave and on all "
          f"{len(texts)}, every quantity equal (max abs err {err_b}); K1 "
          f"{k1:.4f} / {k2:.4f} ms (means of 10), plain {p1:.1f} / "
          f"{p2:.1f} ms [{card}]", flush=True)

    # (c) "auto" on a double array whose conversion fails
    class NoMatrix(DaTokenizer):
        def to_matrix(self):
            raise ValueError("no dense form (smoke phase 4b)")

    nm = NoMatrix()
    nm.__dict__.update(vars(da))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng_nm = dtt.BatchEngine(nm, device="cuda")
    if not any("falling back to the serial-gather engine" in str(w.message)
               for w in caught):
        raise RuntimeError("da (c): a failed conversion did not warn")
    if eng_nm.engine != "general" or eng_nm.tables.kind != "DATOK":
        raise RuntimeError("da (c): a failed conversion left the double array")
    sub = texts[:2048]
    kt.transduce.launches = kt.transduce_general.launches = 0
    evs_nm = eng_nm.events_batch(sub, as_arrays=True)
    launches_c = kt.transduce_general.launches
    if launches_c < 1 or kt.transduce.launches:
        raise RuntimeError("da (c): the double-array form did not launch")
    if not all(np.array_equal(x, y) for x, y in zip(evs_nm, evs)):
        raise RuntimeError("da (c): lanes differ from (b)")
    print(f"da (c): 'auto' with a failing to_matrix() warned "
          f"({len(caught)} warning(s)) and ran {len(sub)} lanes on the card "
          f"through K1's double-array form (launches {launches_c}), equal "
          f"to (b) [{card}]", flush=True)

    # (d) in turns: the double array, the matrix general, the matrix full
    meta_f, lengths_f, _ = eng.encoder.encode_batch(texts)
    args_f = (eng.tables, *to_cuda(meta_f, lengths_f), steps_w)
    d1, r_da = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    g1, r_mg = cuda_ms(lambda: kt.transduce_general(*args_mg), n=10, warmup=2)
    f1, _ = cuda_ms(lambda: kt.transduce(*args_f), n=10, warmup=2)
    d2, _ = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    ms = (d1 + d2) / 2
    n_chars = max(int(lengths.sum()), 1)
    kern = k1_kernel(int(meta.shape[0]), chip["n_sm"], "general", "da")
    instr = chip["step_instr"][kern]
    # bytes: a (word, check) pair of each state the walk reads, and the
    # hop table's entries
    bound, by, n_b, b_ms, n_steps, ops_ms = k1_bound(
        args[1:5], r_da, w4["seen"], instr, chip["n_sm"], chip["clock_hz"],
        w4["seen"] + 2 * n_hop)
    warp = warp_max_steps(r_da[4])
    print(f"da (d): in turns, B={meta.shape[0]} x L={meta.shape[1]}, "
          f"double array / matrix general / matrix full / double array: "
          f"{d1:.4f} / {g1:.4f} / {f1:.4f} / {d2:.4f} ms (means of 10); "
          f"double array / matrix general {ms / g1:.3f} [{card}]",
          flush=True)
    print(f"da (d): K1 double-array form: {n_steps} steps, "
          f"{n_steps / n_chars:.4f} steps/char (matrix general "
          f"{int(r_mg[4].long().sum()) / n_chars:.4f}), a warp's slowest "
          f"lane {warp:.1f} steps on average, {instr} instructions a step "
          f"({kern}); bound {bound:.4f} ms by {by} (instructions "
          f"{ops_ms:.4f} ms, bytes {n_b} = {b_ms:.4f} ms); mean {ms:.4f} "
          f"ms, {ms / bound:.2f}x its bound [{card}]", flush=True)

    # the hop table spread over one entry a state of phase 4's model (a
    # real model's largest, ~147 KB), each representative's cells dealt
    # out to its copies, so that the hops read all of it: the same
    # results, checked, and timed in turns with the table as built
    tb_s = tables_from_tokenizer(da, "cuda", spread=eng.tok.state_count)
    rows = int(tb_s.hop.shape[0])
    err_s = max_abs_err(kt.transduce_general(tb_s, *sl, steps_w), plain_sl)

    def spread():
        return kt.transduce_general(tb_s, *args[1:])

    b1, _ = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    s1, r_s = cuda_ms(spread, n=10, warmup=2)
    s2, _ = cuda_ms(spread, n=10, warmup=2)
    b2, _ = cuda_ms(lambda: kt.transduce_general(*args), n=10, warmup=2)
    err_s = max(err_s, max_abs_err(r_s, r_da))
    if err_s != 0:
        raise RuntimeError(f"da (d): the spread hop table changed K1's "
                           f"results (max abs err {err_s})")
    print(f"da (d): the hop table spread over {rows} entries ({8 * rows} "
          f"bytes): equal to the plain machine on 1024 lanes and to K1 on "
          f"the wave; in turns, as built / spread / spread / as built: "
          f"{b1:.4f} / {s1:.4f} / {s2:.4f} / {b2:.4f} ms (means of 10); "
          f"spread / as built {(s1 + s2) / (b1 + b2):.3f} [{card}]",
          flush=True)

    # (e) phase 8(a)'s stream, pipelined on the double-array engine
    t0 = time.perf_counter()
    text_a = "".join(t + "\x04\n" for t in texts)
    want_a = native_oracle(eng, text_a)
    print(f"da (e): stream (a) of phase 8, {len(text_a.encode('utf-8'))} "
          f"bytes, {len(texts)} documents; its native oracle in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    st = {}
    kt.transduce.launches = kt.transduce_general.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dtt.tokenize_stream_pipelined(
        da, text_a, dtt.NativeWriter(dtt.SIMPLE), engine=eng_da,
        stats=st).getvalue()
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    launches_e = kt.transduce_general.launches
    if launches_e < 1 or kt.transduce.launches:
        raise RuntimeError("da (e): the stream did not run the double-array "
                           "form alone")
    check_same("da (e) pipelined", got, want_a)
    n_e = len(text_a.encode("utf-8"))
    print(f"da (e): phase 8(a)'s stream pipelined (defaults) on the double "
          f"array: {n_e / wall_e / 1e6:.2f} MB/s ({n_e} bytes in "
          f"{wall_e:.3f} s), K1 launches {launches_e}, byte-equal to the "
          f"native oracle; {stage_line(st, wall_e)}; stats {json.dumps(st)} "
          f"[{card}]", flush=True)
    block = {
        "launches": launches_b + launches_c + launches_e,
        "launches_by_part": {"b": launches_b, "c": launches_c,
                             "e": launches_e},
        "max_abs_err": max(err_a, err_b, err_s), "ms": ms,
        "plain_ms": (p1 + p2) / 2, "bound_ms": bound, "bound_by": by,
        "step_instr": instr, "kernel": kern, "turns_ms": [d1, g1, f1, d2],
        "hop_entries": n_hop, "pairs_build_s": pairs_s,
        "hop_share": n_hops / max(n_succ, 1),
        "spread_hop": {"entries": rows, "bytes": 8 * rows,
                       "turns_ms": [b1, s1, s2, b2], "max_abs_err": err_s},
        "matrix_general_ms": g1, "matrix_full_ms": f1,
        "steps_per_char": n_steps / n_chars, "warp_max_steps_mean": warp,
        "n_cells": tb.n_cells, "separate_slots": sep,
        "e2e_mbps": n_bytes / wall / 1e6, "stream_mbps": n_e / wall_e / 1e6,
    }
    return block, (text_a, want_a), da


def profile_wave(dtt, eng, texts, card, reps=3):
    """Where the wave's time goes: the main path's stages, each timed
    on the host clock between synchronizations, ``events_batch`` alone,
    and one ``events_batch`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from datok_tpu_torch.kernels import transduce as kt
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
        lap("h2d")
        ev, counts, bad, _state, _steps, _cold = kt.transduce(*args)
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


def probe_inputs(dev, H=None, B=None):
    """KF's and KP's inputs at the probes' default size (``H`` rows a
    plane, ``B`` lanes): the probes' seeded planes, lanes and ring, with
    out-of-range values written into some lanes (a = 0, negative,
    >= 256; h < 0, >= H)."""
    from datok_tpu_torch.bench_micro.planes import (fetch_inputs,
                                                    fetch_planes_from_numpy,
                                                    fused_inputs,
                                                    fused_planes_from_numpy)
    B0, H0, _K = PROBE_SHAPE
    H = H0 if H is None else H
    B = B0 if B is None else B
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


def device_us(fn, n=20, tries=3):
    """Device microseconds per call of ``fn`` (its kernels and copies),
    from ``torch.profiler`` over ``n`` calls after a warm-up; a session
    that recorded no device time (seen now and then) is run again, up to
    ``tries`` sessions, and raises after that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / n
        if us > 0:
            return us
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       "sessions")


def exact_err(x, y):
    return max(int((p.long() - q.long()).abs().max()) for p, q in zip(x, y))


def persistent_check(mf, dev, n_sm, card):
    """KP's shared-memory form at ``PROBE_B_LOOP`` lanes, once, against
    its plain version: more lanes than the persistent blocks hold, so
    each thread walks further lanes, and 256-thread blocks whose ring
    window holds fewer than K steps, so each lane refills it.  Raises
    unless the plan is that form and KP equals the plain loop."""
    B, H, K = PROBE_B_LOOP, PROBE_SHAPE[1], PROBE_SHAPE[2]
    _, args = probe_inputs(dev, H, B)
    p = mf.plan(H, B, K, n_sm)
    if not (p.form == "smem" and p.ring_rows < K and p.grid * p.threads < B):
        raise RuntimeError(f"KP's plan at H={H} B={B}: {p}, not a looping "
                           "form with a refilled window")
    err = exact_err(mf.micro_fused(*args, K), mf.micro_fused_plain(*args, K))
    if err != 0:
        raise RuntimeError(f"KP at B={B} differs from its plain version "
                           f"(max abs err {err})")
    print(f"probe micro_fused[persistent]: B={B} H={H} K={K}, {p}: "
          f"{-(-B // (p.grid * p.threads))} lanes a thread, the window "
          f"refilled every {p.ring_rows} steps; equal to its plain version "
          f"(max abs err {err}) [{card}]", flush=True)
    return {"H": H, "B": B, "K": K, "grid": p.grid, "threads": p.threads,
            "ring_rows": p.ring_rows, "max_abs_err": err}


def probe_phase(card, dev):
    """Phase 6: KF, prepared once (``HotFetch``), with the select on and
    off, and KP in both forms (H=384: the planes in shared memory;
    H=512: in L2) against their plain versions on the same CUDA tensors,
    timed in turns, KF beside one ``torch.take`` that gives the same
    values (with the select on from the prepared words at a precomputed
    index); KP's shared-memory form once more, checked and untimed, at
    ``PROBE_B_LOOP`` lanes; then the three probe scripts once each,
    with the wrapper's launch counts read around each and the launches
    their graph replays ran.  Returns the kernels' entries of the
    final ``kernels`` line, each with its bound from the bytes it must
    move (its operations, a few integer operations a lane-step, bound it
    far lower) and, for KF with the select off, the time of that
    ``torch.take``, the one call that computes the same function."""
    from datok_tpu_torch.bench_micro import (micro_ablate, micro_fused,
                                             micro_pallas)
    from datok_tpu_torch.kernels import hot_fetch as hf
    from datok_tpu_torch.kernels import micro_fused as mf

    B, H, K = PROBE_SHAPE
    fetch_args, fused_args = probe_inputs(dev)
    _, fused_l2 = probe_inputs(dev, PROBE_H_L2)
    a, h, planes = fetch_args
    n_sm = mf.sm_count(dev.index or 0)
    for args, form in ((fused_args, "smem"), (fused_l2, "l2")):
        p = mf.plan(args[1].shape[0] // 2, B, K, n_sm)
        if p.form != form:
            raise RuntimeError(f"KP's plan at H={args[1].shape[0] // 2}: {p}")
        print(f"probe micro_fused: H={args[1].shape[0] // 2}: {p}", flush=True)
    loop = persistent_check(mf, dev, n_sm, card)
    # bytes each function must move: its inputs read once, its outputs
    # written once; KF without the select reads column 0 of the planes
    fetch_bytes = 4 * B + 4 * B + planes.numel() + 4 * B
    fetch0_bytes = 4 * B + N_SYMBOLS + 4 * B

    def fused_bytes(ring, planes_i8):
        return (4 * B * min(K, ring.shape[0]) + planes_i8.numel() + 4 * B
                + 4 * K * B + 4 * B)

    fetch_on, fetch_off = hf.HotFetch(planes, 3, True), hf.HotFetch(planes, 3, False)
    # the same values by one torch.take: with the select on, the
    # prepared words (three planes' bytes, the fourth 0) at the lane's
    # index; with it off, column 0 of the planes at the lane's symbol;
    # lanes the masks drop sent to a 0 appended to each
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    words_on = torch.cat([fetch_on.words.reshape(-1), zero])
    column0 = torch.cat([planes[:, 0].to(torch.int32), zero])
    in_a = (a > 0) & (a < N_SYMBOLS)
    idx_on = torch.where(in_a & (h >= 0) & (h < H), a * H + h,
                         words_on.numel() - 1).long()
    idx_off = torch.where(in_a, a, N_SYMBOLS).long()
    cases = [  # (name, kernel, plain, lane-steps a call, bytes, take)
        ("hot_fetch[select]", lambda: fetch_on(a, h),
         lambda: hf.hot_fetch_plain(*fetch_args, 3, True), B, fetch_bytes,
         lambda: torch.take(words_on, idx_on)),
        ("hot_fetch[no_select]", lambda: fetch_off(a, h),
         lambda: hf.hot_fetch_plain(*fetch_args, 3, False), B, fetch0_bytes,
         lambda: torch.take(column0, idx_off)),
        ("micro_fused", lambda: mf.micro_fused(*fused_args, K),
         lambda: mf.micro_fused_plain(*fused_args, K), B * K,
         fused_bytes(*fused_args[:2]), None),
        ("micro_fused[l2]", lambda: mf.micro_fused(*fused_l2, K),
         lambda: mf.micro_fused_plain(*fused_l2, K), B * K,
         fused_bytes(*fused_l2[:2]), None),
    ]
    res = {}
    for name, kern, plain, lane_steps, n_bytes, take in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = exact_err(got, want)
        if err != 0:
            raise RuntimeError(f"{name} differs from its plain version "
                               f"(max abs err {err})")
        # in turns: plain, kernel, [take, take,] kernel, plain
        p1, _ = cuda_ms(plain, n=10, warmup=2)
        k1, _ = cuda_ms(kern, n=100, warmup=2)
        t1 = t2 = t_dev = None
        if take is not None:
            if exact_err((take(),), got) != 0:
                raise RuntimeError(f"{name}: torch.take differs")
            t1, _ = cuda_ms(take, n=100, warmup=2)
            t2, _ = cuda_ms(take, n=100, warmup=2)
        k2, _ = cuda_ms(kern, n=100, warmup=2)
        p2, _ = cuda_ms(plain, n=10, warmup=2)
        ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        k_dev, p_dev = device_us(kern), device_us(plain)
        if take is not None:
            t_dev = device_us(take)
        res[name] = {"err": err, "ms": ms, "plain_ms": p_ms,
                     "bound_ms": bound_ms(n_bytes), "device_us": k_dev,
                     "plain_device_us": p_dev}
        line = (f"probe {name}: B={B} H={PROBE_H_L2 if name.endswith('[l2]') else H}"
                f"{f' K={K}' if 'fused' in name else ''}, equal to its plain "
                f"version (max abs err {err}); per call (CUDA events) "
                f"kernel {k1:.4f} / {k2:.4f} ms (means of 100), plain "
                f"{p1:.4f} / {p2:.4f} ms (means of 10)")
        if take is not None:
            res[name].update(take_ms=(t1 + t2) / 2, take_device_us=t_dev)
            line += (f", torch.take {t1:.4f} / {t2:.4f} ms (means of 100, "
                     f"between the kernel's turns; kernel / take "
                     f"{ms / ((t1 + t2) / 2):.3f})")
        print(line + f"; device time a call (torch.profiler) kernel "
              f"{k_dev:.3f} us, plain {p_dev:.3f} us"
              + ("" if t_dev is None else f", torch.take {t_dev:.3f} us")
              + f"; bound {bound_ms(n_bytes) * 1e3:.4f} us ({n_bytes} bytes "
              f"at 3.35 TB/s; device time / bound "
              f"{k_dev / (bound_ms(n_bytes) * 1e3):.2f}); ns_per_lane_step "
              f"kernel {ms * 1e6 / lane_steps:.4f} (device "
              f"{k_dev * 1e3 / lane_steps:.4f}) [{card}]", flush=True)

    # the probe scripts, each with its kernel's count read around it and
    # the launches its graph replays ran
    launches, replayed, steps = {}, {}, {}
    for mod, counter in ((micro_pallas, hf.hot_fetch), (micro_fused, mf.micro_fused),
                         (micro_ablate, hf.hot_fetch)):
        name = mod.__name__.rsplit(".", 1)[1]
        counter.launches = 0
        t0 = time.perf_counter()
        rows = mod.main()
        launches[name] = counter.launches
        if counter.launches < 1:
            raise RuntimeError(f"{name}.main() launched no kernel")
        replayed[name] = sum(r.get("graph_launches", 0) for r in rows)
        steps[name] = {r["variant"]: r for r in rows}
        graph = ", ".join(
            f"{r['variant']} {r['us_per_step']:.3f} us a step as graph "
            f"replays / {r['eager_us_per_step']:.3f} eager"
            for r in rows if "eager_us_per_step" in r)
        print(f"probe script {name}: {counter.launches} launches by the "
              f"wrapper, {replayed[name]} more in graph replays, "
              f"{time.perf_counter() - t0:.2f} s{'; ' + graph if graph else ''}"
              f" [{card}]", flush=True)

    def driver(script, variant):
        r = steps[script][variant]
        return {"graph_us_per_step": r["us_per_step"],
                "eager_us_per_step": r["eager_us_per_step"],
                "graph_launches": replayed[script]}

    src = "datok_tpu_torch/csrc/"
    l2 = res["micro_fused[l2]"]
    rows = [("hot_fetch[select]", "hot_fetch.cu",
             "bench_micro/micro_pallas.py:58", launches["micro_pallas"],
             {**driver("micro_pallas", "cuda_3p"),
              "take_ms": res["hot_fetch[select]"]["take_ms"]}, None),
            ("micro_fused", "micro_fused.cu", "bench_micro/micro_fused.py:87",
             launches["micro_fused"],
             {"l2_form": {"H": PROBE_H_L2, "max_abs_err": l2["err"],
                          "ms": l2["ms"], "plain_ms": l2["plain_ms"],
                          "device_us": l2["device_us"],
                          "bound_ms": l2["bound_ms"]},
              "persistent_form": loop}, None),
            ("hot_fetch[no_select]", "hot_fetch.cu",
             "bench_micro/micro_ablate.py:133", launches["micro_ablate"],
             driver("micro_ablate", "cuda_matmul_only"),
             res["hot_fetch[no_select]"]["take_ms"])]
    return [{"name": name, "route": "cuda", "source": src + source,
             "replaces": replaces, "launches": n,
             "max_abs_err": res[name]["err"], "ms": res[name]["ms"],
             "plain_ms": res[name]["plain_ms"],
             "bound_ms": res[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": library, "device_us": res[name]["device_us"],
             **extra}
            for name, source, replaces, n, extra, library in rows]


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


def stream_phase(dtt, kt, eng, eng_hot, card, profile=False):
    """Phase 7: the stream through three surfaces, each byte-equal to
    the native oracle over the whole stream as one lane, then, untimed,
    ``tokenize_stream`` on ``eng_hot`` for its hot set's cold share;
    ``profile`` adds a host profile (cProfile) of one more
    ``tokenize_stream``.  Returns the stream, its oracle output and
    that cold share."""
    from datok_tpu_torch.runtime.machine import MAX_SEGMENT

    tok = eng.tok
    t0 = time.perf_counter()
    text = stream_text(tok, STREAM_DOCS, STREAM_LONG, STREAM_POOL)
    data = text.encode("utf-8")
    long_docs = sum(len(d) > MAX_SEGMENT for d in text.split("\x04"))
    print(f"stream: {len(data)} bytes, {text.count(chr(4))} EOTs, {long_docs} "
          f"documents over MAX_SEGMENT, made in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    want = native_oracle(eng, text)
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
    torch.cuda.synchronize()
    eng_hot.reset_cold()
    check_same("tokenize_stream auto, hot set", dtt.tokenize_stream(
        tok, text, dtt.NativeWriter(dtt.SIMPLE), engine=eng_hot,
        long_strategy="auto").getvalue(), want)
    torch.cuda.synchronize()
    cold = eng_hot.cold_share
    print(f"stream: cold share of K1's steps in one tokenize_stream (auto) "
          f"with the auto hot set ({eng_hot.hot_size} states) {cold:.6f} "
          f"[{card}]", flush=True)
    if profile:
        host_profile(lambda: surfaces[0][1](dtt.NativeWriter(dtt.SIMPLE)),
                     "one tokenize_stream (auto)", "cumulative", card)
    return text, want, cold


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


def states_read(tok, meta, lengths):
    """How many states' rows a walk of each lane's meta reads (the
    native census), for K1's bound."""
    from datok_tpu_torch.utils.native import native_state_census

    meta, lengths = meta.cpu().numpy(), lengths.cpu().numpy()
    seen = np.zeros(tok.state_count + 1, dtype=bool)
    for i in range(len(lengths)):
        seen |= native_state_census(tok, meta[i, : lengths[i]])[0] > 0
    return int(seen.sum())


def overlap_phase(dtt, kt, eng, eng_hot, card, wave_docs, stream7, chip,
                  stream_a, profile=False):
    """Phase 8: (a) the phase-4 wave's texts as one stream of documents
    ending in ``\\x04\\n``, through ``tokenize_stream_pipelined`` (lanes=8192,
    pack_len=0, and the defaults) and the serial ``tokenize_stream``;
    (b) phase 7's stream through ``tokenize_stream_pipelined``.  Each
    output must equal the native oracle.  Then, untimed, (a) with the
    defaults on ``eng_hot``, whose first wave, as the pipeline launched
    it, runs through K1 with no hot set and with ``eng_hot``'s in turns.
    That wave also runs through K1's general and full forms in turns
    (:func:`form_turns`).  Returns K1's launches in the timed runs, the
    hot set's cold share of the untimed run, the wave's K1 times and
    stream (a) with its oracle output.  ``stream_a`` is stream (a) with
    its native oracle output (made in phase 4b)."""
    from datok_tpu_torch.runtime import engine as engine_mod
    tok = eng.tok
    text_a, want_a = stream_a
    text_b, want_b, _ = stream7
    waves = []

    def capture(tb, meta, lengths, entries, stops, max_steps, **kw):
        # a copy of the first wave's inputs, on the launching stream
        if not waves:
            waves.append((tb, meta.clone(), lengths.clone(), entries.clone(),
                          stops.clone(), max_steps))
        return kt.transduce(tb, meta, lengths, entries, stops, max_steps, **kw)

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
    # untimed: (a) with the defaults on the hot set's engine, its first
    # wave kept
    torch.cuda.synchronize()
    eng_hot.reset_cold()
    engine_mod.transduce = capture
    try:
        got = dtt.tokenize_stream_pipelined(
            tok, text_a, dtt.NativeWriter(dtt.SIMPLE), engine=eng_hot).getvalue()
    finally:
        engine_mod.transduce = kt.transduce
    check_same("overlap (a) pipelined defaults, hot set", got, want_a)
    torch.cuda.synchronize()
    cold = eng_hot.cold_share
    print(f"overlap: cold share of K1's steps in (a) with the defaults and "
          f"the auto hot set ({eng_hot.hot_size} states) {cold:.6f} "
          f"[{card}]", flush=True)
    (z1, h1, h2, z2), share = k1_turns(waves[0], eng_hot.tables, eng.tables)
    B, L = waves[0][1].shape
    print(f"overlap: K1 in turns on (a)'s first wave (defaults), B={B} x "
          f"L={L}, hot_size=0 / auto / auto / 0: {z1:.4f} / {h1:.4f} / "
          f"{h2:.4f} / {z2:.4f} ms (means of 10); cold share of the launch "
          f"{share:.6f} [{card}]", flush=True)
    _, meta8, lengths8 = waves[0][:3]
    forms = form_turns((eng.tables, *waves[0][1:]), "overlap (a)'s first wave",
                       chip, card, states_read(tok, meta8, lengths8))
    wave8 = {"B": int(B), "L": int(L), "ms": (z1 + z2) / 2,
             "ms_auto": (h1 + h2) / 2, "cold_share": share, "forms": forms}
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
    return launches, cold, wave8, (text_a, want_a)


def corpus_phase(dtt, kt, eng, card, wave_docs):
    """Phase 9: the synthetic model saved as a ``.matok``; 64 files cut
    from phase 8(a)'s documents (4 cut mid-word without EOT, 1 empty)
    through ``datok_tpu_torch.cli.main(["corpus", ...])``, each output
    equal to the native oracle; a second run must skip every file and
    launch nothing; ``python -m datok_tpu_torch.cli tokenize --batch``
    on one file in a subprocess must print the oracle's bytes.  Returns
    K1's launches and the printed stats of the first corpus run, the
    files' texts and their outputs."""
    import contextlib
    import tempfile

    from datok_tpu_torch import cli

    n_files = 64
    texts = corpus_texts(wave_docs, n_files)
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
        outputs = []
        for f, t in zip(files, texts):
            with open(os.path.join(out, os.path.basename(f) + ".tok"),
                      encoding="utf-8") as fh:
                outputs.append(fh.read())
            check_same(f"corpus {os.path.basename(f)}", outputs[-1],
                       native_oracle(eng, t))
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
                   native_oracle(eng, texts[13]))
        print(f"cli: python -m datok_tpu_torch.cli tokenize --batch --device "
              f"{eng.device} on {os.path.basename(pick)} ({len(texts[13])} "
              f"characters, ends mid-word): stdout byte-equal to the native "
              f"oracle, {time.perf_counter() - t0:.2f} s with start-up "
              f"[{card}]", flush=True)
    return launches, stats, texts, outputs

# One rank of phase 10(c): joins the group from MASTER_ADDR, MASTER_PORT,
# WORLD_SIZE and RANK, shards over its row of the device grid (LOCAL_RANK
# picks its card), runs the corpus once to warm up, then fresh and again
# into the output directory, and writes its reduced counters, K1
# launches and wall seconds of the last two runs to a JSON file.
RANK_WORKER = r"""
import json, sys, time
import torch, torch.distributed
from datok_tpu_torch import ShardedEngine, load_tokenizer_file
from datok_tpu_torch.kernels import transduce as kt
from datok_tpu_torch.parallel import distributed as dist
model, out_dir, result, *files = sys.argv[1:]
if not dist.initialize() or dist.get_world_size() != 2:
    raise RuntimeError("the process group did not form")
devices = dist.global_mesh()[dist.get_rank()]
eng = ShardedEngine(load_tokenizer_file(model), devices=devices)
# a warm-up run into another directory: pinned host memory, the native
# library and K1 come up outside the timed runs
dist.run_corpus_distributed(eng.tok, files, out_dir + ".warm", engine=eng)
runs = []
for _ in range(2):
    kt.transduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = dist.run_corpus_distributed(eng.tok, files, out_dir, engine=eng)
    torch.cuda.synchronize()
    runs.append({"stats": st, "launches": kt.transduce.launches,
                 "wall_s": time.perf_counter() - t0})
with open(result, "w", encoding="utf-8") as f:
    json.dump({"rank": dist.get_rank(), "devices": [str(d) for d in devices],
               "fresh": runs[0], "resume": runs[1]}, f)
torch.distributed.destroy_process_group()
"""


def k1_windows(seng, run):
    """One ``run()`` of ``seng``'s sharded launch with each K1 launch
    between two CUDA events on its shard's stream; returns each shard's
    (card, start ms, end ms), counted from an event recorded on that
    card before the run (windows on one card share a clock)."""
    from datok_tpu_torch.kernels import transduce as kt
    from datok_tpu_torch.runtime import engine as engine_mod

    marks, starts = [], {}

    def timed(*args, **kw):
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        begin.record()
        res = kt.transduce(*args, **kw)
        end.record()
        marks.append((torch.cuda.current_device(), begin, end))
        return res

    cards = sorted({d.index for d in seng.devices})
    for c in cards:
        torch.cuda.synchronize(c)
        with torch.cuda.device(c):
            starts[c] = torch.cuda.Event(enable_timing=True)
            starts[c].record()
    engine_mod.transduce = timed
    try:
        run()
    finally:
        engine_mod.transduce = kt.transduce
    for c in cards:
        torch.cuda.synchronize(c)
    return [(c, starts[c].elapsed_time(b), starts[c].elapsed_time(e))
            for c, b, e in marks]


def wave_counters(dtt, eng, texts):
    """Phase 10's reference counters: the single engine's events of the
    wave (each lane's first ``counts`` columns) and exit states."""
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    ev, counts, bad, _steps, state = eng.run_raw(meta, lengths)
    kinds = np.where(np.arange(ev.shape[1])[None, :] < counts[:, None],
                     ev & 3, 0)
    return {"tokens": int((kinds == dtt.EV_TOKEN).sum()),
            "sentences": int((kinds == dtt.EV_SENT).sum()),
            "texts": int((kinds == dtt.EV_TEXT).sum()),
            "chars": int(lengths.sum()),
            "backtracks": int(state[:, 4].sum()),
            "force_emits": int(state[:, 5].sum()),
            "fallback_lanes": int(bad.sum())}


def shard_phase(dtt, kt, eng, card, devices, texts, evs4, stream8, corpus9):
    """Phase 10: the sharded engine over ``devices`` (None: every card).  (a) Phase 4's wave through ``events_batch``: every lane equal
    to phase 4's (which equal the native oracle), one K1 launch a shard;
    ``corpus_stats`` equal to the counters of the single engine's
    events; ``events_batch`` and the sharded launch timed in turns
    against the single engine's, and each shard's K1 between CUDA
    events on its stream, which shows whether shards sharing a card
    overlapped.  (b) Phase 8(a)'s
    stream through ``tokenize_stream_pipelined`` on the sharded engine,
    byte-equal to the native oracle, in turns with the single engine.
    (c) Two processes over gloo, each
    on ``cuda:{rank % device_count}``, through ``run_corpus_distributed``
    on phase 9's 64 files: outputs byte-equal to phase 9's, the reduced
    counters equal to phase 9's run, and a second run skipping every
    file.  Returns K1's launches on (a), (b) and (c) and the phase's
    numbers."""
    import socket
    import tempfile

    from datok_tpu_torch.parallel.mesh import ShardedEngine

    tok = eng.tok
    n_cards = torch.cuda.device_count()
    seng = ShardedEngine(tok, devices=devices)
    n = seng.n_shards
    where = (f"{n} shards on {', '.join(str(d) for d in seng.devices)}; "
             f"torch.cuda.device_count() {n_cards}: "
             + ("shards share a card, so this measures the sharded launch "
                "path, not scaling" if len(set(seng.devices)) < n
                else "one shard a card"))
    print(f"shard: {where} [{card}]", flush=True)
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)

    # (a) the wave
    torch.cuda.synchronize()
    kt.transduce.launches = 0
    evs = seng.events_batch(texts, as_arrays=True)
    launches_a = kt.transduce.launches
    if launches_a != n:
        raise RuntimeError(f"shard (a): {launches_a} K1 launches for {n} "
                           "shards")
    for i, (got, want) in enumerate(zip(evs, evs4)):
        if not np.array_equal(got, want):
            raise RuntimeError(f"shard (a): lane {i} differs from phase 4's "
                               f"events: {texts[i][:80]!r}")
    steps = seng.last_shard_steps
    stats = seng.corpus_stats(texts)
    want = wave_counters(dtt, eng, texts)
    diff = {k: (stats[k], v) for k, v in want.items() if stats[k] != v}
    if diff:
        raise RuntimeError(f"shard (a): corpus_stats differ from the single "
                           f"engine's counters (got, want): {diff}")
    print(f"shard (a): events_batch of phase 4's {len(texts)} lanes equal to "
          f"phase 4's, K1 launches {launches_a} (one a shard), shard steps "
          f"{steps.tolist()}; corpus_stats {json.dumps(stats)} equal to the "
          f"single engine's counters [{card}]", flush=True)

    def wall(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.events_batch(texts, as_arrays=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall(eng)
    wall(seng)
    eb = [wall(eng), wall(seng), wall(seng), wall(eng)]
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    args = to_cuda(meta, lengths)
    single = lambda: kt.transduce(eng.tables, *args,  # noqa: E731
                                  eng.max_steps_for(meta.shape[1]))
    sharded = lambda: seng._launch(*args)  # noqa: E731
    k = [cuda_ms(f, n=10, warmup=2)[0]
         for f in (single, sharded, sharded, single)]
    windows = k1_windows(seng, sharded)
    if len(windows) != n:
        raise RuntimeError(f"shard (a): {len(windows)} K1 windows for {n} "
                           "shards")
    # on each card shared by shards: did some K1 start before the one
    # before it ended, and their summed time over the span of their union
    shared = {}
    for c, a, b in windows:
        shared.setdefault(c, []).append((a, b))
    shared = {c: sorted(w) for c, w in shared.items() if len(w) > 1}
    overlapped = {c: any(a2 < b1 for (_, b1), (a2, _) in zip(w, w[1:]))
                  for c, w in shared.items()}
    concurrency = {c: sum(b - a for a, b in w)
                   / (max(b for _, b in w) - min(a for a, _ in w))
                   for c, w in shared.items()}
    print(f"shard (a): events_batch in turns, single / sharded / sharded / "
          f"single: {' / '.join(f'{x:.1f}' for x in eb)} ms "
          f"({n_bytes / (eb[0] + eb[3]) * 2 / 1e3:.2f} / "
          f"{n_bytes / (eb[1] + eb[2]) * 2 / 1e3:.2f} MB/s); the launch "
          f"(CUDA events, means of 10), one K1 / the sharded launch ({n} K1 "
          f"on their streams) / the same / one K1: "
          f"{' / '.join(f'{x:.4f}' for x in k)} ms [{card}]", flush=True)
    print(f"shard (a): each shard's K1 between CUDA events on its stream, "
          f"ms from an event on its card before the launch: "
          f"{', '.join(f'cuda:{c} {a:.4f}-{b:.4f}' for c, a, b in windows)}; "
          f"on a card shared by shards, overlapped {json.dumps(overlapped)}, "
          f"concurrency (their summed time over the span of their union) "
          f"{json.dumps(concurrency)} [{card}]", flush=True)

    # (b) the pipelined stream, in turns with the single engine
    text_a, want_a = stream8
    nb = len(text_a.encode("utf-8"))

    def pipelined(e):
        st = {}
        kt.transduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dtt.tokenize_stream_pipelined(
            tok, text_a, dtt.NativeWriter(dtt.SIMPLE), engine=e,
            stats=st).getvalue()
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        check_same(f"shard (b) pipelined on {type(e).__name__}", got, want_a)
        return w, kt.transduce.launches, st

    turns = [pipelined(e) for e in (eng, seng, seng, eng)]
    launches_b = turns[1][1] + turns[2][1]
    if min(turns[1][1], turns[2][1]) < n:
        raise RuntimeError(f"shard (b): K1 launches by run "
                           f"{[t[1] for t in turns]}")
    mbps_b = [nb / w / 1e6 for w, _, _ in turns]
    print(f"shard (b): phase 8(a)'s stream pipelined (defaults) in turns, "
          f"single / sharded / sharded / single: "
          f"{' / '.join(f'{x:.2f}' for x in mbps_b)} MB/s ({nb} bytes), each "
          f"byte-equal to the native oracle; K1 launches of the sharded runs "
          f"{launches_b}; the first's {stage_line(turns[1][2], turns[1][0])}"
          f" [{card}]", flush=True)

    # (c) two processes over gloo
    launches9, stats9, texts9, outputs9 = corpus9
    with tempfile.TemporaryDirectory(prefix="datok-smoke-dist-") as d:
        model = os.path.join(d, "synth.matok")
        tok.save(model)
        files = []
        for i, t in enumerate(texts9):
            files.append(os.path.join(d, f"doc{i:02d}.txt"))
            with open(files[-1], "w", encoding="utf-8") as f:
                f.write(t)
        out = os.path.join(d, "out")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "WORLD_SIZE": "2",
               "PYTHONPATH": root}
        results = [os.path.join(d, f"rank{r}.json") for r in range(2)]
        logs = [open(os.path.join(d, f"rank{r}.err"), "w+", encoding="utf-8")
                for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_WORKER, model, out, res, *files],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=root,
            stdout=subprocess.DEVNULL, stderr=log, text=True)
            for r, (res, log) in enumerate(zip(results, logs))]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_c = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            err = log.read()
            log.close()
            if p.returncode != 0:
                raise RuntimeError(f"shard (c): rank {r} exit code "
                                   f"{p.returncode}: {err[-3000:]}")
        ranks = []
        for res in results:
            with open(res, encoding="utf-8") as f:
                ranks.append(json.load(f))
        fresh = ranks[0]["fresh"]["stats"]
        if ranks[1]["fresh"]["stats"] != fresh or fresh["processes"] != 2:
            raise RuntimeError(f"shard (c): the ranks' counters differ: "
                               f"{[r['fresh']['stats'] for r in ranks]}")
        keys = ("done", "skipped", "total", "bytes_in", "bytes_out")
        if any(fresh[k] != stats9[k] for k in keys):
            raise RuntimeError(f"shard (c): {fresh} against phase 9's "
                               f"{stats9}")
        for r in ranks:
            again = r["resume"]
            if ((again["stats"]["done"], again["stats"]["skipped"])
                    != (0, len(files)) or again["launches"]):
                raise RuntimeError(f"shard (c) resume: rank {r['rank']}: "
                                   f"{again}")
        for f, want9 in zip(files, outputs9):
            with open(os.path.join(out, os.path.basename(f) + ".tok"),
                      encoding="utf-8") as fh:
                check_same(f"shard (c) {os.path.basename(f)}", fh.read(),
                           want9)
        for m in ("manifest.p0.json", "manifest.p1.json"):
            if not os.path.exists(os.path.join(out, m)):
                raise RuntimeError(f"shard (c): no {m}")
    per_rank = [r["fresh"]["launches"] for r in ranks]
    if min(per_rank) < 1:
        raise RuntimeError(f"shard (c): K1 launches by rank {per_rank}")
    walls = [r["fresh"]["wall_s"] for r in ranks]
    print(f"shard (c): 2 processes over gloo on "
          f"{', '.join(str(r['devices']) for r in ranks)}: "
          f"{json.dumps(fresh)} equal to phase 9's counters, every output "
          f"byte-equal to phase 9's; K1 launches by rank {per_rank}; a "
          f"rank's run {' / '.join(f'{w:.3f}' for w in walls)} s "
          f"({stats9['bytes_in'] / max(walls) / 1e6:.2f} MB/s over both); "
          f"the resume skipped all {len(files)} files with 0 launches on "
          f"both ranks; {wall_c:.2f} s with the processes' start-up "
          f"[{card}]", flush=True)
    launches_c = sum(per_rank)
    return launches_a + launches_b + launches_c, {
        "shards": n, "devices": [str(d) for d in seng.devices],
        "device_count": n_cards, "events_batch_ms": eb,
        "launch_ms": k, "k1_windows_ms": windows, "overlapped": overlapped,
        "concurrency": concurrency, "pipelined_mbps": mbps_b,
        "launches": {"a": launches_a, "b": launches_b, "c": launches_c},
        "corpus_rank_wall_s": walls}


def evs_equal(a, b, label):
    """Raise unless two waves' per-lane (N, 3) events are equal."""
    if len(a) != len(b):
        raise RuntimeError(f"{label}: {len(a)} lanes against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            raise RuntimeError(f"{label}: lane {i} differs")


def set_turns(rest, tbs, n=10):
    """K1 on the same inputs ``rest`` with each of the tables ``tbs``
    (name -> tables, each with its own hot set), in turns: forward, then
    backward, each the mean of ``n`` launches after a warm-up.  All must
    give the same results.  Returns ({name: [ms, ms]}, {name: the
    launch's cold share})."""
    from datok_tpu_torch.kernels import transduce as kt

    res = {k: kt.transduce(tb, *rest) for k, tb in tbs.items()}
    first = next(iter(res.values()))
    for k, r in res.items():
        err = max_abs_err(first[:5], r[:5])
        if err:
            raise RuntimeError(f"K1 with the set {k!r} differs (max abs err "
                               f"{err})")
    times = {k: [] for k in tbs}
    for k in list(tbs) + list(reversed(list(tbs))):
        ms, _ = cuda_ms(lambda: kt.transduce(tbs[k], *rest), n=n, warmup=2)
        times[k].append(ms)
    share = {k: r[5][0].item() / max(r[5][1].item(), 1)
             for k, r in res.items()}
    return times, share


def turns_line(times, share):
    return "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms (cold "
                     f"share {share[k]:.6f})" for k, v in times.items())


def rung_tables(eng, counts):
    """The tables with a wave's sets at the ladder's rungs below the
    engine's own size: the census ``counts``' top states at each rung,
    filled from the engine's set as ``wave_spec`` fills them, tagged on
    the card (what a wave whose working set fit the rung would take)."""
    from dataclasses import replace

    from datok_tpu_torch.runtime.hot import census_cut, wave_hot_states
    from datok_tpu_torch.runtime.rep import hot_table

    out = {}
    for rung in eng.WAVE_H_LADDER:
        if rung < eng.hot_size:
            _, kept = census_cut(counts, rung, ())
            states = wave_hot_states(kept, eng.tables.hot.states[:rung])
            out[f"rung {rung}"] = replace(eng.tables,
                                         hot=hot_table(eng.tables, states))
    return out


def rot_lanes(text, B, L):
    """B lanes of ``text`` repeated and rotated by a per-lane offset, L
    characters each."""
    rep = text * (L // len(text) + 2)
    return [rep[(i * 131) % len(text):][:L] for i in range(B)]


def wave_hot_phase(dtt, kt, eng, eng_hot, texts, w4, stream_a, stream7,
                   card):
    """Phase 11: per-wave hot sets, the adaptive router and
    ``engine="hot"`` on the card.  (a) phase 4's wave through
    ``BatchEngine(tok, hot_size="auto", per_wave=True)``: every lane and
    the bytes equal to phase 4's, the census and tagging times, the
    rung, the set and its cold share, and K1 in turns with no hot set,
    the profiled set, the wave's own and its sets at the ladder's rungs
    (:func:`rung_tables`); (b) phase 8(a)'s stream
    pipelined on that engine: bytes equal to the oracle's, the census
    timed, at least two distinct wave sets launched (phase 7's stream
    if (a)'s waves all take one), the first wave's K1 in turns as in
    (a), and pipelined MB/s in turns with ``per_wave=False`` on the same
    profiled set and with ``hot_size=0``; (c) ``AdaptiveEngine`` with a
    narrow set of ``ADAPTIVE_NARROW`` states: the cold rates and
    choices of an in-profile and a rare-word-dense wave of phase 4's
    shape, the narrow and wide engines byte-equal to the default engine
    on both, ``cold_rate``'s time; (d) ``engine="hot"`` on phase 4's
    wave, equal to phase 4's bytes, K1 in turns against the default
    engine's.  Returns K1's launches on these paths and the numbers for
    the kernels line."""
    from dataclasses import replace

    from datok_tpu_torch.runtime import engine as engine_mod
    from datok_tpu_torch.runtime.hot import _CALIBRATION, census_cut
    from datok_tpu_torch.runtime.rep import hot_table

    tok = eng.tok
    B, L = WAVE_SHAPE
    launches = {}
    out = {}
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    rest4 = (*to_cuda(meta, lengths), eng.max_steps_for(meta.shape[1]))

    # (a) phase 4's wave with its own set
    eng_pw = dtt.BatchEngine(tok, device="cuda", hot_size="auto",
                             per_wave=True)
    if not eng_pw.per_wave:
        raise RuntimeError("phase 11 (a): the engine is not per-wave")
    torch.cuda.synchronize()
    kt.transduce.launches = 0
    t0 = time.perf_counter()
    evs = eng_pw.events_batch(texts, as_arrays=True)
    got = format_wave(texts, evs)
    wall = time.perf_counter() - t0
    launches["a"] = kt.transduce.launches
    if launches["a"] < 1:
        raise RuntimeError("phase 11 (a): K1 was not launched")
    evs_equal(evs, w4["evs"], "phase 11 (a) per-wave")
    if got != w4["out"]:
        raise RuntimeError("phase 11 (a): bytes differ from phase 4's")
    cold_pw = eng_pw.last_cold_share
    spec = eng_pw.wave_spec(texts)  # the cached set the launch took
    if spec is eng_pw.tables.hot:
        raise RuntimeError("phase 11 (a): the wave took the profiled set")
    census = []
    for _ in range(5):
        t0 = time.perf_counter()
        counts = eng_pw.census_states(texts)
        census.append((time.perf_counter() - t0) * 1e3)
    H, kept = census_cut(counts, eng_pw.hot_size, eng_pw.WAVE_H_LADDER)
    tag_ms, _ = cuda_ms(lambda: hot_table(eng_pw.tables, spec.states),
                        n=10, warmup=2)
    n_census = int((counts > 0).sum())
    from_census = int(np.isin(spec.states[1:], kept).sum())
    print(f"phase 11 (a): phase 4's wave through BatchEngine(hot_size="
          f"'auto', per_wave=True): {len(texts)} lanes and the bytes equal "
          f"to phase 4's, {wall:.3f} s, K1 launches {launches['a']}; census "
          f"{' / '.join(f'{c:.2f}' for c in census)} ms (host), tagging "
          f"{tag_ms:.4f} ms (CUDA events, mean of 10); {n_census} states "
          f"in the census, rung {H} (ladder {eng_pw.WAVE_H_LADDER}, own "
          f"set {eng_pw.hot_size}), set {spec.H} states, {from_census} "
          f"from the census and {spec.H - 1 - from_census} filled; "
          f"last_cold_share {cold_pw:.6f} [{card}]", flush=True)
    tbs = {"hot_size=0": eng.tables, "auto": eng_hot.tables,
           "wave": replace(eng_pw.tables, hot=spec),
           **rung_tables(eng_pw, counts)}
    times4, share4 = set_turns(rest4, tbs)
    print(f"phase 11 (a): K1 in turns on phase 4's wave (means of 10): "
          f"{turns_line(times4, share4)} [{card}]", flush=True)
    out["a"] = {"census_ms": census, "tag_ms": tag_ms, "rung": H,
                "census_states": n_census, "set": spec.H,
                "from_census": from_census, "last_cold_share": cold_pw,
                "turns": times4, "cold_share": share4}

    # (b) phase 8(a)'s stream pipelined on the per-wave engine
    text_a, want_a = stream_a
    text_b, want_b, _ = stream7
    seen, first = [], []

    def capture(tb, meta, lengths, entries, stops, max_steps, **kw):
        seen.append(tb.hot)
        if not first:  # a copy of the first wave, on its stream
            first.append((tb, meta.clone(), lengths.clone(),
                          entries.clone(), stops.clone(), max_steps))
        return kt.transduce(tb, meta, lengths, entries, stops, max_steps,
                            **kw)

    wave_docs = []  # the documents of the first wave the census took
    wave_spec = eng_pw.wave_spec

    def keep_docs(docs, *a, **kw):
        if not wave_docs:
            wave_docs.append(list(docs))
        return wave_spec(docs, *a, **kw)

    engine_mod.transduce = capture
    eng_pw.wave_spec = keep_docs
    try:
        for name, text, want in (("8(a)", text_a, want_a),
                                 ("7", text_b, want_b)):
            seen.clear()
            st = {}
            got = dtt.tokenize_stream_pipelined(
                tok, text, dtt.NativeWriter(dtt.SIMPLE), engine=eng_pw,
                stats=st).getvalue()
            torch.cuda.synchronize()
            check_same(f"phase 11 (b) {name}", got, want)
            if not st["census"] > 0:
                raise RuntimeError(f"phase 11 (b) {name}: no census time")
            n_sets = len({id(h) for h in seen})
            print(f"phase 11 (b): phase {name}'s stream pipelined on the "
                  f"per-wave engine: byte-equal to the native oracle, "
                  f"{st['waves']} waves, {n_sets} distinct wave sets "
                  f"launched, census {st['census']:.4f} s "
                  f"({st['census'] / max(st['waves'], 1) * 1e3:.2f} ms a "
                  f"wave, host) [{card}]", flush=True)
            out[f"b_{name}"] = {"waves": st["waves"], "sets": n_sets,
                                "census_s": st["census"]}
            if n_sets >= 2:
                break
    finally:
        engine_mod.transduce = kt.transduce
        del eng_pw.wave_spec
    if n_sets < 2:
        raise RuntimeError("phase 11 (b): fewer than two distinct wave sets")
    tb8, *rest8 = first[0]
    counts8 = eng_pw.census_states(wave_docs[0])
    times8, share8 = set_turns(rest8, {"hot_size=0": eng.tables,
                                       "auto": eng_hot.tables, "wave": tb8,
                                       **rung_tables(eng_pw, counts8)})
    B8, L8 = rest8[0].shape
    print(f"phase 11 (b): K1 in turns on the first wave, B={B8} x L={L8}, "
          f"its own set {tb8.hot.H} states (means of 10): "
          f"{turns_line(times8, share8)} [{card}]", flush=True)
    out["b_wave"] = {"B": int(B8), "L": int(L8), "set": tb8.hot.H,
                     "turns": times8, "cold_share": share8}
    n_bytes = len(text_a.encode("utf-8"))
    engines = {"per_wave": eng_pw, "per_wave=False": eng_hot,
               "hot_size=0": eng}
    mbps = {k: [] for k in engines}
    for k in engines:
        launches[f"b {k}"] = 0
    for k in list(engines) + list(reversed(list(engines))):
        st = {}
        torch.cuda.synchronize()
        kt.transduce.launches = 0
        t0 = time.perf_counter()
        got = dtt.tokenize_stream_pipelined(
            tok, text_a, dtt.NativeWriter(dtt.SIMPLE), engine=engines[k],
            stats=st).getvalue()
        torch.cuda.synchronize()
        mbps[k].append(n_bytes / (time.perf_counter() - t0) / 1e6)
        n = kt.transduce.launches
        check_same(f"phase 11 (b) turns {k}", got, want_a)
        # each engine's own count: one launch at least for each wave
        if n < max(st["waves"], 1):
            raise RuntimeError(f"phase 11 (b) turns {k}: K1 launched {n} "
                               f"times on {st['waves']} waves")
        launches[f"b {k}"] += n
    print(f"phase 11 (b): pipelined_mbps in turns on phase 8(a)'s stream "
          f"(defaults): " + "; ".join(
              f"{k} {' / '.join(f'{x:.2f}' for x in v)} (K1 launches "
              f"{launches[f'b {k}']})" for k, v in mbps.items())
          + f" [{card}]", flush=True)
    out["b_mbps"] = mbps

    # (c) the adaptive router
    t0 = time.perf_counter()
    ae = dtt.AdaptiveEngine(tok, device="cuda", hot_size=ADAPTIVE_NARROW,
                            per_wave=False)
    waves = {"in-profile": rot_lanes(_CALIBRATION * 8, B, L),
             "rare-word-dense": rot_lanes(COLD_HEAVY, B, L)}
    rates, choice, rate_ms = {}, {}, {}
    for k, w in waves.items():
        rates[k] = ae.cold_rate(w)
        choice[k] = ae.choose(w) is ae.wide and "wide" or "narrow"
        if choice[k] != ae.last_choice or (
                (rates[k] > ae.threshold) != (choice[k] == "wide")):
            raise RuntimeError(f"phase 11 (c): {k}: choice {choice[k]} at "
                               f"cold rate {rates[k]}")
        t1 = time.perf_counter()
        for _ in range(20):
            ae.cold_rate(w)
        rate_ms[k] = (time.perf_counter() - t1) / 20 * 1e3
    if sorted(choice.values()) != ["narrow", "wide"]:
        raise RuntimeError(f"phase 11 (c): the waves did not take both "
                           f"routes: {choice}")
    launched = []  # the hot set of each launch through the router

    def spy(tb, *a, **kw):
        launched.append(tb.hot)
        return kt.transduce(tb, *a, **kw)

    for k in ("narrow", "wide", "routed"):
        launches[f"c {k}"] = 0
    for k, w in waves.items():
        want = eng.events_batch(w, as_arrays=True)
        want_b = format_wave(w, want)
        for side in ("narrow", "wide"):
            e = getattr(ae, side)
            kt.transduce.launches = 0
            got = e.events_batch(w, as_arrays=True)
            launches[f"c {side}"] += kt.transduce.launches
            evs_equal(got, want, f"phase 11 (c) {k} {side}")
            if format_wave(w, got) != want_b:
                raise RuntimeError(f"phase 11 (c): {k} {side}: bytes differ")
        # the router's own entry point: it runs on the engine it chose
        launched.clear()
        engine_mod.transduce = spy
        kt.transduce.launches = 0
        try:
            got = ae.events_batch(w)
        finally:
            engine_mod.transduce = kt.transduce
        launches["c routed"] += kt.transduce.launches
        chosen = getattr(ae, choice[k]).tables.hot
        if (ae.last_choice != choice[k] or not launched
                or any(h is not chosen for h in launched)):
            raise RuntimeError(f"phase 11 (c): {k}: the router did not run "
                               f"on the {choice[k]} engine")
        evs_equal([np.asarray(e, dtype=np.int32).reshape(-1, 3)
                   for e in got], want, f"phase 11 (c) {k} routed")
    for k in ("narrow", "wide", "routed"):
        if launches[f"c {k}"] < 2:
            raise RuntimeError(f"phase 11 (c): K1 launched "
                               f"{launches[f'c {k}']} times on the {k} path")
    print(f"phase 11 (c): AdaptiveEngine(hot_size={ADAPTIVE_NARROW}, "
          f"per_wave=False), wide {ae.wide.hot_size} states, threshold "
          f"{ae.threshold}, built in {time.perf_counter() - t0:.2f} s: "
          + "; ".join(f"{k} wave ({B} x {L}) cold rate {rates[k]:.6f} -> "
                      f"{choice[k]}, cold_rate {rate_ms[k]:.3f} ms a call"
                      for k in waves)
          + "; narrow, wide and the router's choice equal to the default "
          f"engine on every lane and byte, K1 launches narrow "
          f"{launches['c narrow']}, wide {launches['c wide']}, routed "
          f"{launches['c routed']} [{card}]", flush=True)
    out["c"] = {"narrow": ADAPTIVE_NARROW, "wide": ae.wide.hot_size,
                "cold_rate": rates, "choice": choice, "cold_rate_ms": rate_ms}

    # (d) engine="hot"
    eng_h = dtt.BatchEngine(tok, device="cuda", engine="hot")
    if eng_h.engine != "hot" or eng_h.tables.hot is None:
        raise RuntimeError("phase 11 (d): engine='hot' has no hot set")
    kt.transduce.launches = 0
    evs = eng_h.events_batch(texts, as_arrays=True)
    launches["d"] = kt.transduce.launches
    if launches["d"] < 1:
        raise RuntimeError("phase 11 (d): K1 was not launched")
    evs_equal(evs, w4["evs"], "phase 11 (d) engine='hot'")
    if format_wave(texts, evs) != w4["out"]:
        raise RuntimeError("phase 11 (d): bytes differ from phase 4's")
    times_h, share_h = set_turns(rest4, {"default": eng.tables,
                                         "hot": eng_h.tables})
    print(f"phase 11 (d): engine='hot' ({eng_h.hot_size} states) on phase "
          f"4's wave: every lane and the bytes equal to phase 4's, K1 "
          f"launches {launches['d']}; K1 in turns (means of 10): "
          f"{turns_line(times_h, share_h)} [{card}]", flush=True)
    out["d"] = {"set": eng_h.hot_size, "turns": times_h,
                "cold_share": share_h}
    out["launches"] = launches
    return sum(launches.values()), out


# phase 12: the benchmark's rows that run in the smoke, each this many
# timed runs after two warm-ups, the pipelined stream at this many MB
# and the corpus on this many files
BENCH_ROWS = ("uniform", "hetero", "mixed", "novel", "datok", "datok_general",
              "e2e", "pipelined", "corpus")
BENCH_REPS, BENCH_E2E_MB, BENCH_FILES = 3, 8, 16


def bench_phase(tok, da, card):
    """Phase 12: the port's benchmark (``datok_tpu_torch.bench``) in this
    process at phase 4's shape, on phase 4's model and phase 4b's double
    array: the rows :data:`BENCH_ROWS` at reduced size.  Each row must
    be correct and have launched K1 in its own runs (the benchmark
    raises otherwise; checked again here); prints the benchmark's line.
    Returns K1's full-form launches over the phase and the numbers for
    the ``kernels`` line: each row's launches and MB/s."""
    from datok_tpu_torch import bench

    t0 = time.perf_counter()
    line = bench.Bench("cuda", *WAVE_SHAPE, reps=BENCH_REPS,
                       e2e_mb=BENCH_E2E_MB, tok=tok, da=da,
                       corpus_files=BENCH_FILES).run(BENCH_ROWS)
    for name in BENCH_ROWS:
        row = line["rows"][name]
        if row["correct"] is not True or row["k1_launches"] < 1:
            raise RuntimeError(f"phase 12: row {name}: {row}")
    print(json.dumps(line), flush=True)
    print(f"benchmark: rows {', '.join(BENCH_ROWS)} correct, each with its "
          f"own K1 launches {json.dumps(line['k1_launches'])}, in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    full = sum(n for k, n in line["k1_launches"].items()
               if k != "datok_general")
    return full, {"k1_launches": line["k1_launches"],
                  "mbps": {k: r["mbps"] for k, r in line["rows"].items()}}


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
    from datok_tpu_torch.kernels import build, sass
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
    # the fewest instructions one pass of K1's step loop issues, for
    # each of its instantiations, and what the bound needs of the card
    listing = sass.cuobjdump(build.TRANSDUCE.path)
    chip = {"n_sm": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_hz": sass.max_sm_clock_hz(), "step_instr": {}}
    instances = sass.k1_instances(listing)
    want = {(t, f, False) for t in (256, 1024) for f in (False, True)}
    want.add((256, False, True))
    if set(instances) != want:
        raise RuntimeError(f"K1's instantiations {sorted(instances)}, "
                           f"expected {sorted(want)}")
    for key, (fewest, static) in sass.k1_step_instructions(listing).items():
        chip["step_instr"][key] = fewest
        print(f"build: transduce: {key}: step loop {static} "
              f"instructions, {fewest} on its shortest pass (SASS)",
              flush=True)

    # 3. kernel vs plain on the same CUDA tensors
    t0 = time.perf_counter()
    tok = synth_tokenizer(seed=SEED)
    eng = dtt.BatchEngine(tok, device="cuda")
    # phases 3-10 hold the profiled set fixed; phase 11 takes wave sets
    eng_hot = dtt.BatchEngine(tok, device="cuda", hot_size="auto",
                              per_wave=False)
    print(f"model: synthetic, {tok.state_count} states x "
          f"{eng.tables.max_sym} symbols, {4 * eng.tables.n_cells / 1e6:.2f} MB, "
          f"built in {time.perf_counter() - t0:.2f} s; the auto hot set "
          f"{eng_hot.hot_size} states ({4 * eng_hot.tables.hot.rows.numel()} "
          f"bytes of shared memory a block)", flush=True)
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
    rest3 = (*to_cuda(meta3, lengths3, entries3, stops3), max_steps3)
    err3 = 0
    for e in (eng_hot, eng):
        for k1_form, form in ((kt.transduce, "full"),
                              (kt.transduce_general, "general")):
            err3 = max(err3, max_abs_err(
                k1_form(e.tables, *rest3),
                run_machine(e.tables, *rest3, form=form)))
            if err3 != 0:
                raise RuntimeError(
                    f"K1's {form} form with hot set {e.hot_size} differs "
                    f"from the plain machine's (max abs err {err3})")
    args3 = (eng.tables, *rest3)
    # in turns: plain, kernel, kernel, plain (K1 turns: mean of 10)
    p1, _ = cuda_ms(lambda: run_machine(*args3))
    k1, _ = cuda_ms(lambda: kt.transduce(*args3), n=10, warmup=2)
    k2, _ = cuda_ms(lambda: kt.transduce(*args3), n=10, warmup=2)
    p2, _ = cuda_ms(lambda: run_machine(*args3))
    print(f"kernel vs plain: B={B3} x L={L3}, hot sets {eng_hot.hot_size} "
          f"and 0, full and general forms, events/counts/bad/state/steps/"
          f"cold equal (max abs err {err3}); without a hot set K1 {k1:.3f} "
          f"/ {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms [{card}]", flush=True)

    # 4. main path at real size
    texts = wave_texts(tok, *WAVE_SHAPE, synth_text)
    w4 = run_wave(dtt, run_machine, eng, eng_hot, texts, card,
                  "synthetic DE-size model", chip)
    if opts.profile:
        profile_wave(dtt, eng, texts, card)

    # 4b. the DE-size double array on K1's general form over base/check
    da4b, stream_a, da = da_phase(dtt, kt, run_machine, eng, texts, texts3, w4,
                              card, chip)

    # 5. the DE model, if present
    if DE_MODEL and os.path.exists(DE_MODEL):
        tok_de = dtt.load_tokenizer_file(DE_MODEL)
        eng_de = dtt.BatchEngine(tok_de, device="cuda")
        eng_de_hot = dtt.BatchEngine(tok_de, device="cuda", hot_size="auto",
                                     per_wave=False)
        B, L = WAVE_SHAPE
        run_wave(dtt, run_machine, eng_de, eng_de_hot,
                 [bench_lane(i, L) for i in range(B)], card, "DE model", chip)
    else:
        print("DE model: skipped, DATOK_DE_MODEL names no file", flush=True)

    # 6. the probe kernels and their scripts
    probes = probe_phase(card, torch.device("cuda"))

    # 7. streaming at real size
    stream7 = stream_phase(dtt, kt, eng, eng_hot, card,
                           opts.profile)

    # 8. the overlapped pipeline, on phase 4's texts and phase 7's stream
    launches8, cold8, wave8, stream8 = overlap_phase(
        dtt, kt, eng, eng_hot, card, texts, stream7, chip, stream_a,
        opts.profile)

    # 9. the corpus runner and the CLI
    corpus9 = corpus_phase(dtt, kt, eng, card, texts)
    launches9 = corpus9[0]

    # 10. the sharded engine (every card, or cuda:0 twice on one) and two
    # processes over gloo
    devices = None if torch.cuda.device_count() > 1 else ["cuda:0", "cuda:0"]
    launches10, shard10 = shard_phase(dtt, kt, eng, card, devices, texts,
                                      w4["evs"], stream8, corpus9)
    # 11. per-wave hot sets, the adaptive router and engine="hot"
    launches11, phase11 = wave_hot_phase(dtt, kt, eng, eng_hot, texts, w4,
                                         stream_a, stream7, card)
    # 12. the port's benchmark, its rows at reduced size
    launches12, phase12 = bench_phase(tok, da, card)
    launches = w4["launches"]
    cold = {"4": w4["cold_share"], "7": stream7[2], "8": cold8}
    print(f"K1 launches by path: phase 4 wave {launches}, phase 8 "
          f"{launches8}, phase 9 corpus {launches9}, phase 10 sharded "
          f"{launches10} {json.dumps(shard10['launches'])}, phase 11 "
          f"{launches11} {json.dumps(phase11['launches'])}, phase 12 "
          f"{launches12} {json.dumps(phase12['k1_launches'])}; with the auto hot set "
          f"({eng_hot.hot_size} states) the cold share by phase "
          f"{json.dumps(cold)}", flush=True)

    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    jax_pkg = sorted(m for m in sys.modules
                     if m == "datok_tpu" or m.startswith("datok_tpu."))
    if jax_pkg:
        raise RuntimeError(f"the port imported the JAX package: {jax_pkg}")
    print(json.dumps({"kernels": [{
        "name": "transduce",
        "route": "cuda",
        "source": "datok_tpu_torch/csrc/transduce.cu",
        "replaces": "datok_tpu/runtime/pallas_engine.py:384",
        "launches": (launches + launches8 + launches9 + launches10
                     + launches11 + launches12),
        "max_abs_err": max(err3, w4["err"]),
        "ms": w4["ms"],
        "plain_ms": w4["plain_ms"],
        "bound_ms": w4["bound_ms"],
        "bound_by": w4["bound_by"],
        "library_ms": None,
        "hot_size": eng.hot_size,
        "ms_auto": w4["ms_auto"],
        "auto_hot_size": eng_hot.hot_size,
        "cold_share": cold,
        "ms_same_text": w4["ms_same_text"],
        "ms_same_text_auto": w4["ms_same_text_auto"],
        "forms": {"phase4": w4["forms"], "phase8": wave8["forms"]},
        "step_instr": chip["step_instr"],
        "phase8_wave": wave8,
        "phase10": shard10,
        "da": da4b,
        "phase11": phase11,
        "phase12": phase12,
    }] + probes}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
