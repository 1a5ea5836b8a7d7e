"""K1's full step (run skip and fused boundaries) against the reference.

The TPU kernel (``pallas_engine._make_kernel``) runs ``_make_step`` with
the run skip and fused-boundary entries; the port's full form runs the
same step in K1 (its host build, ``transduce_host``) and in the plain
machine (``run_machine``).  Here, at small sizes on the CPU:

* the skip class and the per-state words against the JAX package's
  ``_tok_static`` and ``HotSpec``, on the default synthetic model and
  on its genitive variant, whose skip class drops ``s``;
* the engine's encoder against the JAX Pallas engine's: meta carries
  the same adaptive class;
* the full form against the Pallas kernel in interpret mode and the
  oracle: events and exit rows on the lanes that finish in both, and
  the formatted output after host repair on every lane.  The full form
  fuses every boundary its gates let through, the Pallas kernel only
  those with a hot final target, so step counts and ``bad`` lanes are
  each machine's own;
* the full form against the general form, lane by lane, and the host
  build against the plain machine on every quantity;
* exact step counts of both forms on hand-checked inputs;
* cut lanes, mid-word entry contexts, hot sets and a >2^15-state model.

Every comparison is exact.
"""

import copy

import numpy as np
import pytest
import torch

from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu.runtime.jax_engine import HotSpec, _tok_static
from datok_tpu_torch import BatchEngine
from datok_tpu_torch.kernels.transduce import (transduce, transduce_general,
                                               transduce_host)
from datok_tpu_torch.runtime.decode import (decode_events_batch,
                                            decode_events_compact)
from datok_tpu_torch.runtime.encode import SymbolEncoder
from datok_tpu_torch.runtime.machine import run_machine
from datok_tpu_torch.runtime.oracle import transduce_events
from datok_tpu_torch.runtime.rep import (ST_EPS, ST_EPS_AT_TGT, ST_EPS_TGT,
                                         ST_LC, skip_class, state_table,
                                         tables_from_tokenizer, with_hot)
from datok_tpu_torch.testing.synth import (IDENTITY, ROOT, WORD, synth_text,
                                           synth_tokenizer)
from test_torch_engine import _big_tok
from torch_twins import jax_twin

N_ABBREV, SEED = 430, 1  # ~1,650 states, the size test_torch_kernel uses
MODELS = ["default", "genitive"]
# inputs for the skip and fuse paths: runs past the 31 cap, runs cut by
# the dropped letter s and by non-ASCII and Latin-1 letters, boundaries
# before punctuation, spaces and EOT, sentence ends with no token
# pending, identity characters after a known non-ASCII one (stale ok)
EDGE = ["", "a" * 45 + " " + "b" * 70 + ".", "Hausbesitzers Hausbesitzer.",
        "aaaœaaa ääx straßenbahn.", "ab cd. ef\x04gh ij.\x04\n", "a. c",
        "œ~ab œ x~y", "3~ Mann. 3. x -", "Mann.\x04z.B. Neu-\x04",
        "ab~c 中 😀!"]


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """A model with its JAX Pallas engine (interpret mode, the sizes of
    test_torch_kernel.py), its texts and their meta from the JAX
    engine's encoder, and the Pallas runs, made when first asked for."""
    tok = synth_tokenizer(N_ABBREV, SEED, genitive=request.param == "genitive")
    pallas = JaxEngine(jax_twin(tok), engine="pallas", pallas_interpret=True,
                       kernel_bl=128, kernel_k=16)
    rng = np.random.default_rng(SEED)
    texts = synth_text(tok, 54, [int(x) for x in rng.integers(0, 300, 54)],
                       seed=SEED) + EDGE
    meta, lengths, _ = pallas.encoder.encode_batch(texts)
    return {"name": request.param, "tok": tok, "pallas": pallas,
            "texts": texts, "meta": meta, "lengths": lengths, "runs": {}}


def _inputs(m, case):
    """(entries, stops) of a case: fresh roots; the exit contexts of the
    Pallas run from the root, shuffled, with cut lanes; or every lane
    entering inside a word (a word state with and without ok)."""
    B = len(m["lengths"])
    rng = np.random.default_rng(SEED + 1)
    if case == "root":
        return np.ones(B, np.int32), np.zeros(B, bool)
    if case == "entries_stops":
        state = _pallas(m, "root")[2]
        return (state[:, 0][rng.permutation(B)].astype(np.int32),
                rng.random(B) < 0.3)
    word = np.where(rng.random(B) < 0.5, WORD, WORD | 1 << 30)
    return word.astype(np.int32), rng.random(B) < 0.3


def _pallas(m, case):
    """The Pallas run of a case: (events, bad, state)."""
    if case not in m["runs"]:
        entries, stops = _inputs(m, case)
        ys, bad, n, state = m["pallas"].run_raw(m["meta"], m["lengths"],
                                                entries, stops)
        m["runs"][case] = (decode_events_batch(ys, n, as_arrays=True),
                           np.asarray(bad), np.asarray(state))
    return m["runs"][case]


def _run(fn, tb, meta, lengths, entries, stops, max_steps, **kw):
    """One machine's outputs as numpy, with the events past each lane's
    count zeroed (K1 leaves them unwritten)."""
    out = fn(tb, torch.from_numpy(meta), torch.from_numpy(lengths),
             torch.from_numpy(entries), torch.from_numpy(stops), max_steps,
             **kw)
    ev, counts = out[0].numpy(), out[1].numpy()
    ev = np.where(np.arange(ev.shape[1])[None, :] < counts[:, None], ev, 0)
    return (ev, counts, out[2].numpy(), out[3].numpy(), out[4].numpy(),
            out[5].numpy())


def _full(form):
    """The machines a form runs on: the host build and the plain one."""
    return {"host": lambda *a: transduce_host(*a, form=form),
            "plain": lambda *a: run_machine(*a, form=form)}


# ---- the skip class, the per-state words, the encoder -----------------------

def test_skip_class_matches_jax(model):
    tok = model["tok"]
    st = _tok_static(jax_twin(tok))
    lc_mask, lc_avail = skip_class(tok)
    np.testing.assert_array_equal(lc_mask, st["lc_mask"])
    np.testing.assert_array_equal(lc_avail, st["lc_avail"])
    letters = "".join(chr(c) for c in np.flatnonzero(lc_mask))
    if model["name"] == "genitive":
        # the six genitive word states and the word state absorb, once
        # the greedy drop has taken s out of the class
        assert letters == "abcdefghijklmnopqrtuvwxyz" and lc_avail.sum() == 7
    else:
        assert letters == "abcdefghijklmnopqrstuvwxyz" and lc_avail.sum() == 1
    assert lc_avail[WORD] == 1 and lc_avail[0] == 0


def test_state_table_matches_hotspec(model):
    """Each state's word holds what the Pallas kernel's fused entries
    and registers read of it: ε available (``eps_avail``), absorbing
    (``lc_avail``), the ε target of a hot state (``hot_eps_full``) and
    ε available there (the entries' bit 15)."""
    tok = model["tok"]
    tb = tables_from_tokenizer(tok, "cpu")
    word = tb.state_bits.numpy().astype(np.int64)
    jt = jax_twin(tok)
    st = _tok_static(jt)
    S = tok.state_count
    assert word.shape == (S + 1,)
    np.testing.assert_array_equal((word[1:] & ST_EPS) != 0,
                                  st["eps_avail"][1:] != 0)
    np.testing.assert_array_equal((word & ST_LC) != 0, st["lc_avail"] != 0)
    hot = np.arange(1, min(S, 1000) + 1)
    spec = HotSpec(jt, hot)
    assert spec.fused_ok
    e = word[spec.hot_full] & ST_EPS_TGT
    np.testing.assert_array_equal(e, spec.hot_eps_full)
    np.testing.assert_array_equal(
        (word[spec.hot_full] & ST_EPS_AT_TGT) != 0,
        (e != 0) & (spec.eps_avail[e] != 0))
    np.testing.assert_array_equal(
        word, state_table(tok.array, S, tb.max_sym, tok.epsilon,
                          st["lc_avail"]))


def test_encoder_stamps_the_skip_class(model):
    """The engine's meta is the JAX Pallas engine's, bit for bit below
    the symbol classes (bits 24..30, which only the Pallas kernel
    reads): the run lengths count the adaptive class.  On the genitive
    model the [a-z] default would mark runs through s, where a skip
    would be wrong."""
    eng = BatchEngine(model["tok"], "cpu")
    meta, lengths, _ = eng.encoder.encode_batch(model["texts"])
    assert not (meta >> 24).any()
    np.testing.assert_array_equal(meta, model["meta"] & ((1 << 24) - 1))
    np.testing.assert_array_equal(lengths, model["lengths"])
    plain, _, _ = SymbolEncoder(model["tok"]).encode_batch(model["texts"])
    assert (model["name"] == "genitive") == (not np.array_equal(plain, meta))


# ---- the full form against the Pallas kernel and the oracle -----------------

@pytest.mark.parametrize("machine", ["host", "plain"])
@pytest.mark.parametrize("case", ["root", "entries_stops", "midword"])
def test_full_form_matches_pallas_kernel(model, case, machine):
    entries, stops = _inputs(model, case)
    meta, lengths = model["meta"], model["lengths"]
    tb = tables_from_tokenizer(model["tok"], "cpu")
    ev, counts, bad, state, _, _ = _run(
        _full("full")[machine], tb, meta, lengths, entries, stops,
        model["pallas"].max_steps_for(meta.shape[1]))
    evs = decode_events_compact(ev, counts, as_arrays=True)
    ev_p, bad_p, state_p = _pallas(model, case)
    done = ~bad & ~bad_p
    assert done.mean() > 0.9
    for i in np.flatnonzero(done):
        np.testing.assert_array_equal(evs[i], ev_p[i], err_msg=f"lane {i}")
    np.testing.assert_array_equal(state[done], state_p[done])
    if case == "root":
        for i in np.flatnonzero(~bad):
            ref = transduce_events(model["tok"], model["texts"][i])
            np.testing.assert_array_equal(
                evs[i], np.asarray(ref, np.int32).reshape(-1, 3),
                err_msg=f"lane {i}")


def test_formatted_output_after_repair(model):
    """Every lane's bytes, lanes over a tight budget repaired on the
    host, equal the oracle's and the JAX Pallas engine's."""
    tok, texts = model["tok"], model["texts"]
    eng = BatchEngine(tok, "cpu", steps_factor=0.5)
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    assert eng.run_raw(meta, lengths)[2].sum() > 0  # some lanes repaired
    got = eng.tokenize_batch(texts)
    assert got == [tok.tokenize(t) for t in texts]
    assert got == model["pallas"].tokenize_batch(texts)


# ---- the full form against the general form ---------------------------------

@pytest.mark.parametrize("budget", ["full", "tiny"])
@pytest.mark.parametrize("case", ["root", "entries_stops", "midword"])
def test_full_form_against_general_form(model, case, budget):
    """Per lane: equal events and exit rows wherever both forms finish,
    never more steps in the full form (a fused step stands for three, a
    skip for a run), so a lane the full form leaves unfinished is one
    the general form leaves too.  The host build and the plain machine
    agree on every quantity in each form."""
    entries, stops = _inputs(model, case)
    meta, lengths = model["meta"], model["lengths"]
    max_steps = 2 * meta.shape[1] + 64 if budget == "full" else 40
    tb = tables_from_tokenizer(model["tok"], "cpu")
    out = {}
    for form in ("full", "general"):
        runs = [_run(fn, tb, meta, lengths, entries, stops, max_steps)
                for fn in _full(form).values()]
        for x, y in zip(*runs):
            np.testing.assert_array_equal(x, y, err_msg=form)
        out[form] = runs[0]
    ev_f, counts_f, bad_f, state_f, steps_f, _ = out["full"]
    ev_g, counts_g, bad_g, state_g, steps_g, _ = out["general"]
    assert (budget == "tiny") == bool(bad_g.any())
    assert not (bad_f & ~bad_g).any()
    done = ~bad_f & ~bad_g
    np.testing.assert_array_equal(counts_f[done], counts_g[done])
    np.testing.assert_array_equal(ev_f[done], ev_g[done])
    np.testing.assert_array_equal(state_f[done], state_g[done])
    assert (steps_f[done] <= steps_g[done]).all()
    if budget == "full":
        assert steps_f.sum() < 0.8 * steps_g.sum()


# ---- exact step counts ------------------------------------------------------

def _tiny():
    """The synthetic model with two abbreviations (bzw, z.B), so that
    a and c lead from the root straight to the word state; and a copy
    with an identity arc from the root to the word state, where a
    boundary before an identity character can fuse."""
    tok = synth_tokenizer(2, 0)
    tok_id = copy.deepcopy(tok)
    tok_id.array = tok.array.copy()
    tok_id.array[(IDENTITY - 1) * tok.state_count + ROOT] = WORD
    return tok, tok_id


# (text, entry, with the identity arc, steps full, steps general).  The
# epilogue after a word at the end takes 4 steps in both forms: chase
# the word's ε (1), flush the token (2), end the text with a sentence
# end (3) and drain the text end (4).
HAND = {
    # a lowercase run in the word state: a from the root (1), the run's
    # other 3 letters in one skip (2), epilogue (3-6).  General: 4
    # reads + 4.
    "run": ("aaaa", 1, False, 6, 8),
    # 45 letters: a (1), a skip of 31, the cap (2), a skip of the other
    # 13 (3), epilogue (4-7).  General: 45 + 4.
    "run_past_cap": ("a" * 45, 1, False, 7, 49),
    # a (1), b (2; a run of 1 is not skipped), the space: no arc in the
    # word, the word's ε to the root, the root takes the space: one
    # fused step (m_bf) emits "ab" and consumes it (3), c (4), d (5),
    # epilogue (6-9).  General: the space takes 3 (fail, flush,
    # re-read), so 11.
    "boundary": ("ab cd", 1, False, 9, 11),
    # a (1), "." fused after "a" (2), the space in the sentence state:
    # its ε target has no space arc, so fail (3) and flush "." (4); the
    # second bound's state has no space arc, its ε leads to the root,
    # which takes it, and no token is pending: a fused sentence end
    # (m_bs, 5); c (6), epilogue (7-10).  General: 1 + 3 + 2 + 3 + 1 +
    # 4 = 14.
    "sentence_end": ("a. c", 1, False, 10, 14),
    # a (1), b (2), EOT: the gate keeps it on the slow path: fail (3),
    # flush "ab" (4), re-read EOT, consume, sentence end (5), drain the
    # text end (6), end with nothing left (7).  The same in both forms.
    "eot_boundary": ("ab\x04", 1, False, 7, 7),
    # 3 (1), ~ reads as the identity symbol; ok is clear (a fresh root),
    # so the stale-ok gate keeps it on the slow path although the root
    # would take it: retry unknown (2), fail to the bound (3), flush
    # "3" (4), re-read ~ to the word state (5), epilogue (6-9).
    "identity_stale_ok": ("3~", 1, True, 9, 9),
    # the same with ok set in the entry context: one fused step (2).
    # General: 1 + 3 + 4.
    "identity_ok": ("3~", 1 | 1 << 30, True, 6, 8),
    # a (1), "aa" skipped (2), œ, a non-ASCII letter outside the class,
    # read alone; it sets ok (3); "aaa" skipped (4), epilogue (5-8).
    # General: 7 + 4.
    "nonascii_in_run": ("aaaœaaa", 1, False, 8, 11),
}


@pytest.mark.parametrize("name", list(HAND))
def test_hand_checked_step_counts(name):
    text, entry, ident, n_full, n_general = HAND[name]
    tok = _tiny()[1 if ident else 0]
    tb = tables_from_tokenizer(tok, "cpu")
    meta, lengths, _ = SymbolEncoder(tok, lc_mask=tb.lc_mask).encode_batch(
        [text])
    args = (tb, meta, lengths, np.array([entry], np.int32),
            np.zeros(1, bool), 200)
    runs = {form: [_run(fn, *args) for fn in _full(form).values()]
            for form in ("full", "general")}
    for form, want in (("full", n_full), ("general", n_general)):
        for r in runs[form]:
            assert r[4].tolist() == [want], form
            assert not r[2].any()
        for x, y in zip(*runs[form]):
            np.testing.assert_array_equal(x, y)
    full, general = runs["full"][0], runs["general"][0]
    for k in (0, 1, 3):  # events, counts, exit row
        np.testing.assert_array_equal(full[k], general[k])
    ev = decode_events_compact(full[0], full[1])[0]
    if entry == 1:
        assert ev == transduce_events(tok, text)


# ---- hot sets and a large model ---------------------------------------------

@pytest.mark.parametrize("hot", [1, 8, "auto"])
def test_full_form_with_hot_set(model, hot):
    """Tagged cells and hot rows change only where cells come from: the
    host build with a hot set equals the plain machine without one on
    every quantity but the cold steps, which equal the plain machine's
    on the same tables."""
    entries, stops = _inputs(model, "entries_stops")
    meta, lengths = model["meta"], model["lengths"]
    max_steps = 2 * meta.shape[1] + 64
    tok = model["tok"]
    tb_hot = BatchEngine(tok, "cpu", hot_size=hot).tables
    assert tb_hot.hot is not None
    got = _run(transduce_host, tb_hot, meta, lengths, entries, stops,
               max_steps)
    want = _run(run_machine, tables_from_tokenizer(tok, "cpu"), meta,
                lengths, entries, stops, max_steps)
    for x, y in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(x, y)
    cold = _run(run_machine, tb_hot, meta, lengths, entries, stops,
                max_steps)[5]
    np.testing.assert_array_equal(got[5], cold)
    assert got[5][0] < got[5][1]


def test_hot_set_holds_fused_targets():
    """A hot set that holds the fused steps' final and ε targets (the
    root, the word state, the genitive ones): their hot indices come
    from the tags and from ``hot_of``, and the results stay exact."""
    tok = synth_tokenizer(60, 3, genitive=True)
    S = tok.state_count
    tb = with_hot(tables_from_tokenizer(tok, "cpu"),
                  [ROOT, WORD] + list(range(S - 6, S + 1)))
    texts = synth_text(tok, 20, 200, seed=4) + EDGE
    meta, lengths, _ = SymbolEncoder(tok, lc_mask=tb.lc_mask).encode_batch(
        texts)
    B = len(texts)
    args = (meta, lengths, np.ones(B, np.int32), np.zeros(B, bool),
            2 * meta.shape[1] + 64)
    got = _run(transduce_host, tb, *args)
    want = _run(run_machine, tables_from_tokenizer(tok, "cpu"), *args)
    for x, y in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(x, y)
    assert 0 < got[5][0] < got[5][1]


def test_large_model_full_form():
    """A >2^15-state model, so the per-state words carry 28-bit ε
    targets past the 2^15-state boundary in both forms: a run past its
    chain's end is skipped in the chain's last state, a space after the
    chain is a fused boundary, and both forms match the oracle."""
    tok = _big_tok()
    assert tok.state_count >= 1 << 15
    texts = ["a" * 260 + " aa.", "aaa a. " + "a" * 230 + ".",
             "a a. " + "a" * 150 + " a.", "", ". a"]
    tb = tables_from_tokenizer(tok, "cpu")
    meta, lengths, _ = SymbolEncoder(tok, lc_mask=tb.lc_mask).encode_batch(
        texts)
    B = len(texts)
    args = (tb, meta, lengths, np.ones(B, np.int32), np.zeros(B, bool),
            2 * meta.shape[1] + 64)
    runs = {(form, name): _run(fn, *args)
            for form in ("full", "general")
            for name, fn in _full(form).items()}
    for form in ("full", "general"):
        for x, y in zip(runs[form, "host"], runs[form, "plain"]):
            np.testing.assert_array_equal(x, y)
        r = runs[form, "plain"]
        evs = decode_events_compact(r[0], r[1])
        assert evs == [transduce_events(tok, t) for t in texts]
    assert (runs["full", "plain"][4] < runs["general", "plain"][4]).sum() >= 3
    assert BatchEngine(tok, "cpu").tokenize_batch(texts) == [
        tok.tokenize(t) for t in texts]


# ---- the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_k1_forms_match_plain_machine_on_card():
    """K1's full and general forms against the plain machine's on the
    card, without a hot set and with the auto one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    tok = synth_tokenizer(N_ABBREV, SEED, genitive=True)
    rng = np.random.default_rng(SEED)
    texts = synth_text(tok, 200, [int(x) for x in rng.integers(0, 300, 200)],
                       seed=SEED) + EDGE
    dev = torch.device("cuda")
    for hot in (0, "auto"):
        eng = BatchEngine(tok, dev, hot_size=hot)
        meta, lengths, _ = eng.encoder.encode_batch(texts)
        B = len(texts)
        args = (eng.tables, torch.from_numpy(meta).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.ones(B, dtype=torch.int32, device=dev),
                torch.from_numpy(rng.random(B) < 0.3).to(dev),
                2 * meta.shape[1] + 64)
        for k1, form in ((transduce, "full"), (transduce_general, "general")):
            before = k1.launches
            got = k1(*args)
            torch.cuda.synchronize()
            assert k1.launches == before + 1
            want = run_machine(*args, form=form)
            keep = (torch.arange(got[0].shape[1], device=dev)[None, :]
                    < want[1][:, None])
            assert torch.equal(torch.where(keep, got[0], 0), want[0])
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b)
