"""End-to-end rates of one source tree of the port, for A/B runs.

Runs the port found under ``--root`` (a checkout of this repository) on
the card: phase 4's wave of ``chip_smoke.py`` through
``BatchEngine.events_batch`` and the native writer (``e2e_mbps``), and
phase 8(a)'s stream through ``tokenize_stream_pipelined`` with its
defaults (``pipelined_mbps``), each ``--reps`` times after one warm-up,
every output checked against the first; then both on the same model as
a double array (``synth_datok``, smoke phase 4b) through
``BatchEngine(da, engine="general")`` (``da_e2e_mbps``,
``da_pipelined_mbps``), whose outputs must equal the matrix engine's.
It uses only entry points that every version of the port since the
double-array engine has, so two trees compare in one call, each in its
own process, in turns (A, B, B, A)::

    python3 datok_tpu_torch/bench_micro/e2e_turns.py --root build/parent
    python3 datok_tpu_torch/bench_micro/e2e_turns.py --root .

Prints one JSON line with the rates, the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to run")
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)

    import chip_smoke as cs
    import datok_tpu_torch as dtt
    from datok_tpu_torch.testing.synth import (DE_N_ABBREV, synth_datok,
                                               synth_text, synth_tokenizer)

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    tok = synth_tokenizer(seed=cs.SEED)
    eng = dtt.BatchEngine(tok, device="cuda")
    texts = cs.wave_texts(tok, *cs.WAVE_SHAPE, synth_text)
    n_wave = sum(len(t.encode("utf-8")) for t in texts)
    lens = np.array([len(t) for t in texts], dtype=np.int32)
    offs = np.zeros(len(texts), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    cps = np.frombuffer("".join(texts).encode("utf-32-le"), dtype="<u4")
    cps = cps.astype(np.int32)

    def wave(eng=eng):
        evs = eng.events_batch(texts, as_arrays=True)
        counts = np.array([len(e) for e in evs], dtype=np.int32)
        w = dtt.NativeWriter(dtt.SIMPLE)
        w.feed_wave(np.concatenate(evs), counts, cps, offs, lens)
        return w.getvalue()

    text_a = "".join(t + "\x04\n" for t in texts)
    n_stream = len(text_a.encode("utf-8"))

    def stream(eng=eng):
        return dtt.tokenize_stream_pipelined(
            eng.tok, text_a, dtt.NativeWriter(dtt.SIMPLE),
            engine=eng).getvalue()

    eng_da = dtt.BatchEngine(synth_datok(DE_N_ABBREV, cs.SEED),
                             device="cuda", engine="general")
    runs = [("e2e_mbps", wave, n_wave), ("pipelined_mbps", stream, n_stream),
            ("da_e2e_mbps", lambda: wave(eng_da), n_wave),
            ("da_pipelined_mbps", lambda: stream(eng_da), n_stream)]
    out = {"root": opts.root, "card": card}
    firsts = {}
    for name, fn, n_bytes in runs:
        first = firsts[name] = fn()  # warm-up
        if name.startswith("da_") and first != firsts[name[3:]]:
            raise RuntimeError(f"{name}: the double array's output differs "
                               "from the matrix engine's")
        rates = []
        for _ in range(opts.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            rates.append(n_bytes / (time.perf_counter() - t0) / 1e6)
            if got != first:
                raise RuntimeError(f"{name}: output differs between runs")
        out[name] = rates
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
