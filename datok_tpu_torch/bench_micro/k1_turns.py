"""K1's forms of one source tree of the port on the card, for A/B runs.

Runs K1 of the port found under ``--root`` (a checkout of this
repository) on phase 4's wave of ``chip_smoke.py`` (the synthetic
DE-size model, B=32768 x L=1024, from the root): the full form
(``transduce``, the engine's) and the general form
(``transduce_general``) over the matrix, and the general form over the
same model as a double array (``synth_datok(DE_N_ABBREV)``, the wave's
texts encoded by ``BatchEngine(da, engine="general")``, smoke phase
4b), each the mean of ``--n`` launches between CUDA events after a
warm-up, in turns (full, general, double array, double array, general,
full).  ``--spread`` (a tree whose double array has a hop table) then
times the double-array form with its hop table spread over each number
of entries given (``tables_from_tokenizer(..., spread=)``: each
representative's entry repeated, its cells dealt out to the copies, the
same results), in turns with the table as built (as built, each size
up, each size down, as built).  It also counts the fewest instructions one pass of each instantiation's
step loop issues (``kernels/sass.py`` on ``cuobjdump -sass``) and
prints a digest of each form's outputs (events up to each lane's
count, counts, ``bad``, exit rows, steps), so that two trees can be
held equal, and what ``BatchEngine(tok)`` with its defaults holds: its
hot set's size, whether it takes per-wave sets, and the native censuses
one ``events_batch`` of 1,024 of the wave's texts ran.  It uses entry points that every version of the port
since the double-array form has, so two trees compare in one call, each
in its own process, in turns (A, B, B, A)::

    python3 datok_tpu_torch/bench_micro/k1_turns.py --root build/parent
    python3 datok_tpu_torch/bench_micro/k1_turns.py --root .

Prints one JSON line with the card's name and power limit.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

# an instantiation of K1's kernel template: block size, form, and the
# tables' layout where the tree has one
_K1 = re.compile(r"transduce_kernelILi(\d+)ELb([01])E(?:L\w*?6LayoutE([01])E)?")


def digest(res) -> str:
    """SHA-256 of a launch's outputs, each lane's events past its count
    left out (K1 does not write them)."""
    ev, counts, bad, state, steps = (x.cpu().numpy() for x in res[:5])
    keep = np.arange(ev.shape[1])[None, :] < counts[:, None]
    h = hashlib.sha256()
    for x in (np.where(keep, ev, 0), counts, bad, state, steps):
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to run")
    ap.add_argument("--n", type=int, default=10, help="launches a turn")
    ap.add_argument("--spread", default="",
                    help="hop-table sizes (entries, comma-separated) to "
                         "spread the double array's hops over and time")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.root))

    import chip_smoke as cs
    from datok_tpu_torch import BatchEngine
    from datok_tpu_torch.kernels import build, sass
    from datok_tpu_torch.kernels import transduce as kt
    from datok_tpu_torch.testing.synth import (DE_N_ABBREV, synth_datok,
                                               synth_text, synth_tokenizer)

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    build.load(build.TRANSDUCE)
    step_instr = {}
    listing = sass.cuobjdump(build.TRANSDUCE.path)
    for name in sass.functions(listing):
        m = _K1.search(name)
        if m:
            key = (f"{m.group(1)}/{'full' if m.group(2) == '1' else 'general'}"
                   f"/{'da' if m.group(3) == '1' else 'matrix'}")
            step_instr[key] = sass.loop_min_instructions(listing, name)[0]

    tok = synth_tokenizer(seed=cs.SEED)
    eng = BatchEngine(tok, device="cuda")
    texts = cs.wave_texts(tok, *cs.WAVE_SHAPE, synth_text)
    # the default engine's hot set and censuses (a tree from before
    # per-wave sets has neither)
    from datok_tpu_torch.runtime import engine as engine_mod

    censuses = []
    census = getattr(engine_mod, "native_state_census", None)
    if census is not None:
        engine_mod.native_state_census = (
            lambda *a: censuses.append(1) or census(*a))
    eng.events_batch(texts[:1024])
    defaults = {"hot_size": eng.hot_size,
                "per_wave": getattr(eng, "per_wave", False),
                "censuses": len(censuses)}
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    args = (eng.tables, *cs.to_cuda(meta, lengths),
            eng.max_steps_for(meta.shape[1]))
    # the same texts through the double array's own encoder
    eng_da = BatchEngine(synth_datok(DE_N_ABBREV, cs.SEED), device="cuda",
                         engine="general")
    meta_da, lengths_da, _ = eng_da.encoder.encode_batch(texts)
    args_da = (eng_da.tables, *cs.to_cuda(meta_da, lengths_da),
               eng_da.max_steps_for(meta_da.shape[1]))
    runs = {"full": lambda: kt.transduce(*args),
            "general": lambda: kt.transduce_general(*args),
            "da": lambda: kt.transduce_general(*args_da)}
    turns = {}
    for form in ("full", "general", "da", "da", "general", "full"):
        ms, _ = cs.cuda_ms(runs[form], n=opts.n, warmup=2)
        turns.setdefault(form, []).append(ms)
    # the double array with its hop table spread, each launch equal to
    # the one as built
    spread_turns = {}
    sizes = [int(x) for x in opts.spread.split(",") if x]
    if sizes:
        from datok_tpu_torch.runtime.rep import tables_from_tokenizer

        want = digest(runs["da"]())
        spread = {n: tables_from_tokenizer(eng_da.tok, "cuda", spread=n)
                  for n in sizes}
        for n in ["built", *sizes, *sizes[::-1], "built"]:
            tb = eng_da.tables if n == "built" else spread[n]
            ms, got = cs.cuda_ms(lambda: kt.transduce_general(
                tb, *args_da[1:]), n=opts.n, warmup=2)
            if digest(got) != want:
                raise RuntimeError(f"the hop table spread over {n} entries "
                                   "changed K1's results")
            key = n if n == "built" else int(tb.hop.shape[0])
            spread_turns.setdefault(key, []).append(ms)
    print(json.dumps({
        "root": opts.root, "card": card, "B": int(meta.shape[0]),
        "L": int(meta.shape[1]), "turns_ms": turns,
        "digest": {f: digest(fn()) for f, fn in runs.items()},
        "step_instr": step_instr, "spread_turns_ms": spread_turns,
        "defaults": defaults,
    }), flush=True)


if __name__ == "__main__":
    main()
