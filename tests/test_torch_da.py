"""Double-array models on the port's device path against the JAX general
machine over ``DoubleArrayRep``.

* K1's general step over a double array (interleaved (word, check)
  pairs, a hop table, each state's base carried by the lane), built
  for the host with g++ (``transduce_host(..., form="general")`` on a
  ``.datok`` model's tables, with its hop table as built and spread
  over many entries), against ``jax_engine._run_machine`` with ``DoubleArrayRep``
  on the JAX CPU backend: events, counts, ``bad``, the exit rows and
  steps, from the root and from non-root entries with cuts, under a
  full and a tiny step budget, on lanes that take the separate-state
  hop and on hand-edited tables that reach the three bug-compatible
  quirks (no ``a == 0`` guard, a size test on the transition but not
  on the ε probe, ``base + a`` out of range) and the paths of the
  carried bases (a representative that is itself separate, one
  outside the array, a lane entering at a separate slot, the rows read
  after an ε backtrack and an ``f1`` retry).
* The pairs and hop table (``rep.da_pairs``, as built and spread)
  against ``rep.transition`` on every cell.
* ``BatchEngine(da, device="cpu", engine="general")`` against
  ``jax_engine.BatchEngine(jax_twin(da), engine="general")``, and the
  engine with the host build in the place of its device machine.
* The ``engine=`` routing: a failed conversion under ``"auto"``,
  ``"pallas"`` and ``"hot"`` (which otherwise converts and runs K1's
  full step with a hot set), ``"general"`` on a ``.matok`` model, and
  ``ShardedEngine(..., engine="general")``.
* The wrapper's refusals, the package's names against
  ``datok_tpu.__all__``, and K1 itself on a card (skipped without one).

Every output is an integer or a byte, so every comparison is exact
(tolerance 0).  The stream surfaces on a double-array engine are
parametrizations of tests/test_torch_pipeline.py and
tests/test_torch_overlap.py (kind ``datok_general``).
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datok_tpu
import datok_tpu_torch as dtt
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu.runtime.jax_engine import _run_machine, make_rep
from datok_tpu_torch.fsa.double_array import DaTokenizer
from datok_tpu_torch.fsa.io import FIRSTBIT, RESTBIT
from datok_tpu_torch.kernels import transduce as kt
from datok_tpu_torch.runtime import engine as engine_mod
from datok_tpu_torch.runtime import machine as machine_mod
from datok_tpu_torch.runtime.decode import (decode_events_batch,
                                            decode_events_compact)
from datok_tpu_torch.runtime.encode import SymbolEncoder
from datok_tpu_torch.runtime.machine import run_machine
from datok_tpu_torch.runtime.rep import (_take, da_pairs,
                                         tables_from_tokenizer, transition)
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 60, 5

# the edge texts of tests/test_torch_machine.py: residual flush at EOF,
# EOF backtrack, identity→unknown retry, stale-ok force-emit, EOT inside
# and at the end, sentence punctuation, a long token
EDGE = [
    "", "x -", "3.", "a → b", "œ~", "Mann.", "z.B. bzw. Abk.",
    "Er sagte: „gut“ … und\tging.\x04Neu-\x04",
    "  -x --y 3,50 14:30 5.9.2018.", "ab~c þ ¤ 中文 😀!", "Ende.\x04\n",
    "\x04\x04", "a" * 280 + ".",
]

@pytest.fixture(scope="module")
def da():
    return synth_datok(N_ABBREV, SEED)


@pytest.fixture(scope="module")
def texts(da):
    rng = np.random.default_rng(SEED)
    return synth_text(da, 45, [int(x) for x in rng.integers(0, 300, 45)],
                      seed=SEED) + EDGE


@pytest.fixture(scope="module")
def wave(da, texts):
    meta, lengths, _ = SymbolEncoder(da).encode_batch(texts)
    return meta, lengths


def _jax(tok, meta, lengths, entries, stops, max_steps):
    """The JAX general machine over ``make_rep(jax_twin(tok))``:
    (events per lane, bad, steps, state)."""
    rep = make_rep(jax_twin(tok))
    ys, bad, steps, state = _run_machine(
        tuple(jnp.asarray(t) for t in rep.tables), jnp.asarray(meta),
        jnp.asarray(lengths), jnp.asarray(entries), jnp.asarray(stops),
        eps=rep.eps, unknown=rep.unknown, identity=rep.identity, rep=rep,
        max_steps=max_steps,
    )
    n = int(steps)
    return (decode_events_batch(np.asarray(ys), n, as_arrays=True),
            np.asarray(bad), n, np.asarray(state))


def _args(tb, meta, lengths, entries, stops, max_steps):
    return (tb, torch.from_numpy(meta), torch.from_numpy(lengths),
            torch.from_numpy(entries), torch.from_numpy(stops), max_steps)


# a hop table spread over at least this many entries (rep.da_pairs),
# the form that a model with many representatives gives K1
SPREAD = 1000


def _host(tok, *inputs, spread=0):
    """K1's general step over a double array, built for the host, its
    hop table spread over at least ``spread`` entries: the raw outputs,
    events past each count zeroed."""
    return _masked(kt.transduce_host(*_args(
        tables_from_tokenizer(tok, "cpu", spread), *inputs), form="general"))


def _masked(out):
    """Raw outputs with the events past each count zeroed."""
    ev, counts = out[0], out[1]
    keep = torch.arange(ev.shape[1])[None, :] < counts[:, None]
    return (torch.where(keep, ev, 0),) + tuple(out[1:])


def _decoded(out):
    ev, counts, bad, state, steps, _ = out
    return (decode_events_compact(ev.numpy(), counts.numpy(), as_arrays=True),
            bad.numpy(), int(steps.max()), state.numpy())


def _assert_equal_jax(port, ref):
    (ev_p, bad_p, n_p, state_p), (ev_r, bad_r, n_r, state_r) = port, ref
    np.testing.assert_array_equal(bad_p, bad_r)
    np.testing.assert_array_equal(state_p, state_r)
    assert n_p == n_r
    for i, (a, b) in enumerate(zip(ev_p, ev_r)):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {i}")


def _inputs(tok, wave, case):
    meta, lengths = wave
    B = len(lengths)
    if case == "root":
        return meta, lengths, np.ones(B, np.int32), np.zeros(B, bool)
    # non-root entries: the exit contexts (slot ids) of a first JAX run,
    # shuffled, with cut lanes
    rng = np.random.default_rng(SEED + 1)
    *_, state = _jax(tok, meta, lengths, np.ones(B, np.int32),
                     np.zeros(B, bool), 2 * meta.shape[1] + 64)
    return (meta, lengths, state[:, 0][rng.permutation(B)].astype(np.int32),
            rng.random(B) < 0.3)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the step ---------------------------------------------------------------

@pytest.mark.parametrize("spread", [0, SPREAD])
@pytest.mark.parametrize("budget", ["full", "tiny"])
@pytest.mark.parametrize("case", ["root", "entries_stops"])
def test_host_build_matches_jax_machine(da, wave, case, budget, spread):
    """Every lane and every quantity, unfinished lanes included, with
    the hop table as built and spread over many entries; the plain
    machine gives the same raw outputs, cold counts included."""
    inputs = _inputs(da, wave, case)
    max_steps = 2 * wave[0].shape[1] + 64 if budget == "full" else 40
    host = _host(da, *inputs, max_steps, spread=spread)
    ref = _jax(da, *inputs, max_steps)
    assert (budget == "tiny") == bool(ref[1].any())
    _assert_equal_jax(_decoded(host), ref)
    plain = run_machine(*_args(tables_from_tokenizer(da, "cpu"), *inputs,
                               max_steps), form="general")
    assert _same(host, plain)


def test_lanes_take_the_separate_state_hop(da, wave):
    """The texts reach separate states: with base's separate bits
    cleared (no hop) the host build gives other results, and the JAX
    machine on the unchanged tables still equals it."""
    inputs = _inputs(da, wave, "root")
    max_steps = 2 * wave[0].shape[1] + 64
    base = np.asarray(da.base, np.uint32)
    assert ((base & np.uint32(FIRSTBIT)) != 0).sum() > 1000
    nohop = copy.copy(da)
    nohop.base = base & ~np.uint32(FIRSTBIT)
    assert not _same(_host(da, *inputs, max_steps),
                     _host(nohop, *inputs, max_steps))
    _assert_equal_jax(_decoded(_host(da, *inputs, max_steps)),
                      _jax(da, *inputs, max_steps))


def _target(da, ch):
    """The state the root's arc on ``ch`` leads to (a slot id)."""
    base = np.asarray(da.base, np.uint32)
    tc = int(base[1] & RESTBIT) + da.sigma[ord(ch)]
    return int(base[tc] & RESTBIT) if base[tc] & FIRSTBIT else tc


def _edited(da, quirk):
    """A copy of ``da`` whose tables reach ``quirk``, and the meta
    change (a function of the wave's meta) that drives it."""
    tok = copy.copy(da)
    base = np.array(da.base, np.uint32)
    check = np.array(da.check, np.uint32)
    n = len(base)
    b1 = int(base[1] & RESTBIT)
    sep = (base & np.uint32(FIRSTBIT)) != 0
    reps, hits = np.unique(base[sep] & np.uint32(RESTBIT), return_counts=True)

    def drive(meta):
        return meta

    if quirk == "sep_rep":
        # every representative but the root is itself separate: a hop
        # lands on it and stays there (JAX hops once), with the base it
        # had; an arc that lands on it directly now hops
        reps = reps[(reps < n) & (reps != 1)]
        base[reps] |= np.uint32(FIRSTBIT)
    elif quirk == "rep_outside":
        # the separate cells of the most common representative hop past
        # the array's end, to a state whose cells all read as 0
        r = reps[np.argmax(hits)]
        base[sep & ((base & np.uint32(RESTBIT)) == r)] = (
            np.uint32(FIRSTBIT) | np.uint32(n + 5))
    elif quirk in ("eps_back", "f1_retry"):
        # the arcs on ε (taken only after an ε backtrack, from the base
        # carried for the backtrack register) or on the unknown symbol
        # (the f1 retry, from the base carried for t0) hop to the state
        # after a root's '.'
        sym = da.epsilon if quirk == "eps_back" else da.unknown
        owner = (check & np.uint32(RESTBIT)).astype(np.int64)
        known = owner < n
        cell = np.arange(n)
        arc = known & (cell <= int(check[1] & RESTBIT)) & (
            cell == (base[np.where(known, owner, 0)] & np.uint32(RESTBIT))
            .astype(np.int64) + sym)
        assert arc.sum() > 0
        base[arc] = np.uint32(FIRSTBIT) | np.uint32(_target(da, "."))
    elif quirk == "a0":
        # the root takes symbol 0 (no a == 0 guard): check[base[1]] = 1
        assert int(check[b1] & RESTBIT) != 1
        check[b1] = (check[b1] & np.uint32(FIRSTBIT)) | np.uint32(1)

        def drive(meta):
            m = meta.copy()
            m[::2, 0] = 0  # symbol 0 at the start of every other lane
            m[1::3, 2] = 0
            return m
    elif quirk == "size":
        # the size field below the slots in use: transitions past it
        # fail, ε probes past it still succeed
        size = int(check[1] & RESTBIT) // 2
        check[1] = (check[1] & ~np.uint32(RESTBIT)) | np.uint32(size)
    else:
        # base + a past the arrays: near their end, or at the largest base
        off = n - 3 if quirk == "near_end" else int(RESTBIT)
        base[1] = (base[1] & ~np.uint32(RESTBIT)) | np.uint32(off)
    tok.base, tok.check = base, check
    return tok, drive


@pytest.mark.parametrize("quirk", ["a0", "size", "near_end", "max_base",
                                   "sep_rep", "rep_outside", "eps_back",
                                   "f1_retry"])
@pytest.mark.parametrize("case", ["root", "entries_stops"])
def test_quirks_match_jax_machine(da, wave, case, quirk):
    """Hand-edited tables reach each bug-compatible quirk; the host
    build and the plain machine equal the JAX machine there, and the
    edit changes the result (so the quirk's path ran)."""
    tok, drive = _edited(da, quirk)
    meta, lengths, entries, stops = _inputs(da, wave, case)
    meta = drive(meta)
    max_steps = 2 * meta.shape[1] + 64
    inputs = (meta, lengths, entries, stops, max_steps)
    host = _host(tok, *inputs)
    _assert_equal_jax(_decoded(host), _jax(tok, *inputs))
    assert _same(host, run_machine(*_args(tables_from_tokenizer(tok, "cpu"),
                                          *inputs), form="general"))
    assert _same(host, _host(tok, *inputs, spread=SPREAD))
    assert not _same(host, _host(da, *inputs))


@pytest.mark.parametrize("spread", [0, SPREAD])
def test_entry_at_a_separate_slot_matches_jax_machine(da, wave, spread):
    """A lane may enter at any slot.  At a separate one, whose base word
    is its representative's id r, JAX reads the lane's first row from r
    as a base (``base & RESTBIT`` whatever the bit); K1 reads it from
    the original base array, not from the pair's word (a hop index).
    A separate slot owns no cell, so the edit hands it the cells at r +
    a for every symbol a: one slot a representative.  Entering at the
    representatives instead changes the result."""
    meta, lengths = wave
    B = len(lengths)
    tok = copy.copy(da)
    base = np.asarray(da.base, np.uint32)
    check = np.array(da.check, np.uint32)
    n, size = len(base), int(check[1] & RESTBIT)
    sep = np.flatnonzero(base & np.uint32(FIRSTBIT))
    reps, first = np.unique(base[sep] & np.uint32(RESTBIT), return_index=True)
    slots = sep[first]
    for r, s in zip(reps.astype(np.int64), slots):
        cells = r + np.arange(1, max(da.sigma.values()) + 1)
        cells = cells[(cells < n) & (cells <= size)]
        check[cells] = (check[cells] & np.uint32(FIRSTBIT)) | np.uint32(s)
    tok.check = check
    rng = np.random.default_rng(SEED + 3)
    pick = rng.integers(0, len(slots), B)
    ok = (rng.random(B) < 0.5).astype(np.int64) << 30
    stops = rng.random(B) < 0.3
    max_steps = 2 * meta.shape[1] + 64
    entries = (slots[pick] | ok).astype(np.int32)
    host = _host(tok, meta, lengths, entries, stops, max_steps, spread=spread)
    _assert_equal_jax(_decoded(host),
                      _jax(tok, meta, lengths, entries, stops, max_steps))
    at_rep = (reps[pick].astype(np.int64) | ok).astype(np.int32)
    assert not _same(host, _host(tok, meta, lengths, at_rep, stops,
                                 max_steps, spread=spread))


@pytest.mark.parametrize("spread", [0, SPREAD])
@pytest.mark.parametrize("quirk", ["none", "sep_rep", "rep_outside"])
def test_hop_table_equals_transition_on_every_cell(da, quirk, spread):
    """Where each cell sends a lane, read from the pairs and the hop
    table as K1 reads them, equals ``rep.transition``'s target on every
    cell, and the base K1 carries equals that target's base; the hop
    table has one entry a distinct representative, or, spread, as many
    copies of each as make ``spread`` entries, each representative's
    cells dealt out to its copies in turn; the tables' check is the
    pairs' second word."""
    tok = da if quirk == "none" else _edited(da, quirk)[0]
    tb = tables_from_tokenizer(tok, "cpu", spread)
    base = np.asarray(tok.base, np.uint32)
    n = len(base)
    pairs = tb.pairs.numpy().view(np.uint32)
    hop = tb.hop.numpy().view(np.uint32)
    word = pairs[:, 0]
    np.testing.assert_array_equal(pairs[:, 1], np.asarray(tok.check, np.uint32))
    assert torch.equal(tb.arrays[1], tb.pairs[:, 1])
    assert tb.arrays[1].data_ptr() == tb.pairs.data_ptr() + 4  # a view
    sep = (word & np.uint32(FIRSTBIT)) != 0
    np.testing.assert_array_equal(sep, (base & np.uint32(FIRSTBIT)) != 0)
    j = np.where(sep, word & np.uint32(~FIRSTBIT & 0xFFFFFFFF), 0)
    t_next = np.where(sep, hop[j, 0], np.arange(n, dtype=np.uint32))
    b_next = np.where(sep, hop[j, 1], word & np.uint32(RESTBIT))
    # every cell i as the target of the arc from state 0 on i - base(0)
    b0 = int(base[0] & RESTBIT)
    _, _, t_ref = transition(tb, torch.zeros(n, dtype=torch.int32),
                             torch.from_numpy(np.arange(n) - b0).to(
                                 torch.int32))
    np.testing.assert_array_equal(t_next.astype(np.int64),
                                  t_ref.numpy().astype(np.int64))
    base_t = torch.from_numpy(base.view(np.int32))
    np.testing.assert_array_equal(
        b_next.astype(np.int64),
        (_take(base_t, t_ref.long()) & RESTBIT).numpy().astype(np.int64))
    reps = np.unique(base[sep] & np.uint32(RESTBIT))
    n_hop = len(reps)
    copies = -(-spread // n_hop) if spread else 1
    assert hop.shape == (n_hop * copies, 2)
    np.testing.assert_array_equal(hop, np.tile(hop[:n_hop], (copies, 1)))
    np.testing.assert_array_equal(hop[:n_hop, 0], reps)
    np.testing.assert_array_equal(pairs,
                                  da_pairs(base, tok.check, spread)[0])
    # each representative's cells are dealt out to its copies in turn
    used = np.zeros((n_hop, copies), np.int64)
    np.add.at(used, (j[sep] % n_hop, j[sep] // n_hop), 1)
    assert (used.max(1) - used.min(1) <= 1).all()
    if quirk == "rep_outside":
        assert (hop[:n_hop, 0] >= n).sum() == 1
        assert hop[:n_hop, 1][hop[:n_hop, 0] >= n].tolist() == [0]
    if quirk == "sep_rep":
        assert (base[hop[:n_hop, 0][hop[:n_hop, 0] < n]] >> 31).sum() > 0


def test_probe_without_size_test_is_reached(da, wave, monkeypatch):
    """With the size field cut, a probe that also tested the size would
    change the result: the ε probe's missing size test is on the path."""
    tok, _ = _edited(da, "size")
    inputs = (*_inputs(da, wave, "root"), 2 * wave[0].shape[1] + 64)
    args = _args(tables_from_tokenizer(tok, "cpu"), *inputs)
    want = run_machine(*args, form="general")

    def sized_probe(tb, t):
        base, check = tb.arrays
        tc = (_take(base, t.long()) & RESTBIT).long() + tb.eps
        chk = _take(check, tc) & RESTBIT
        return (tc < tb.n_cells) & (tc <= tb.size) & (chk == t)

    monkeypatch.setattr(machine_mod, "eps_avail", sized_probe)
    assert not _same(want, run_machine(*args, form="general"))


# ---- the engine -------------------------------------------------------------

def _entries_stops(tok, texts):
    """Non-root entries (a first run's exit contexts, shuffled: slot ids
    on a double array) and cuts on the texts that end in EOT, as the
    stream splitter sends."""
    eng = dtt.BatchEngine(tok, device="cpu", engine="general")
    _, exits = eng.events_batch(texts, return_exits=True)
    rng = np.random.default_rng(SEED + 2)
    return (exits[rng.permutation(len(texts))].astype(np.int32),
            np.array([t.endswith("\x04") for t in texts]))


@pytest.mark.parametrize("factor", [2.0, 0.05])
def test_engine_general_matches_jax_engine(da, texts, factor):
    """Events and exit rows from non-root entries with cuts, and the
    formatted bytes, against the JAX engine over the double array; at
    the tiny budget most lanes go ``bad`` and are repaired on the host."""
    eng = dtt.BatchEngine(da, device="cpu", engine="general",
                          steps_factor=factor)
    jeng = JaxEngine(jax_twin(da), engine="general", steps_factor=factor)
    assert eng.engine == jeng.engine == "general"
    assert eng.tables.kind == "DATOK" and eng.tok is da
    # the JAX general engine's encoder (jax_engine.py:1749)
    np.testing.assert_array_equal(eng.encoder.lc_mask,
                                  SymbolEncoder(da).lc_mask)
    entries, stops = _entries_stops(da, texts)
    assert stops.any() and (entries != 1).any()
    got, got_exits = eng.events_batch(texts, entries=entries, stops=stops,
                                      return_exits=True)
    want, want_exits = jeng.events_batch(texts, entries=entries, stops=stops,
                                         return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    if factor < 1:
        meta, lengths, _ = eng.encoder.encode_batch(texts)
        assert eng.run_raw(meta, lengths)[2].sum() > len(texts) // 2
    assert eng.tokenize_batch(texts) == [da.tokenize(t) for t in texts]


def test_engine_runs_host_build_of_da_step(da, texts, monkeypatch):
    """The engine's path with K1's C++ double-array step (g++ host
    build) in the place of its device machine: events and exits equal
    the JAX engine's, bytes equal the oracle's."""
    calls = []

    def host(*args, **kw):
        calls.append(args[0].kind)
        return kt.transduce_host(*args, form="general", **kw)

    def full(*args, **kw):
        raise AssertionError("a general engine launched the full form")

    monkeypatch.setattr(engine_mod, "transduce_general", host)
    monkeypatch.setattr(engine_mod, "transduce", full)
    eng = dtt.BatchEngine(da, device="cpu", engine="general")
    entries, stops = _entries_stops(da, texts)
    jeng = JaxEngine(jax_twin(da), engine="general")
    assert (eng.events_batch(texts, entries=entries, stops=stops,
                             return_exits=True)[0]
            == jeng.events_batch(texts, entries=entries, stops=stops,
                                 return_exits=True)[0])
    assert eng.tokenize_batch(texts) == [da.tokenize(t) for t in texts]
    assert calls and set(calls) == {"DATOK"}


class _NoMatrix(DaTokenizer):
    """A double array whose conversion to the matrix fails."""

    def to_matrix(self):
        raise ValueError("no dense form")


def _no_matrix(da):
    tok = _NoMatrix()
    tok.__dict__.update(vars(da))
    return tok


def test_auto_keeps_double_array_when_conversion_fails(da, texts):
    """``"auto"`` warns with the JAX engine's message and runs the
    general step over the double array; ``"pallas"`` raises."""
    tok = _no_matrix(da)
    with pytest.warns(RuntimeWarning, match="double-array → matrix "
                      "conversion failed .*falling back to the "
                      "serial-gather engine"):
        eng = dtt.BatchEngine(tok, device="cpu")
    assert eng.engine == "general" and eng.tables.kind == "DATOK"
    assert eng.tok is tok
    assert eng.tokenize_batch(texts) == [da.tokenize(t) for t in texts]
    with pytest.raises(RuntimeError, match="engine='pallas' requires the "
                       "dense matrix layout but to_matrix\\(\\) failed"):
        dtt.BatchEngine(tok, device="cpu", engine="pallas")


@pytest.mark.parametrize("kind", ["matok", "datok"])
def test_auto_and_pallas_run_the_full_form_on_a_matrix(da, kind):
    tok = synth_tokenizer(N_ABBREV, SEED) if kind == "matok" else da
    for engine in ("auto", "pallas"):
        eng = dtt.BatchEngine(tok, device="cpu", engine=engine)
        assert eng.engine == "pallas" and eng.tables.kind == "MATOK"
        assert eng._kernel() is kt.transduce
        np.testing.assert_array_equal(eng.encoder.lc_mask,
                                      eng.tables.lc_mask)


def test_hot_and_unknown_engines_raise(da, texts):
    """``engine="hot"`` converts a ``.datok`` model and runs K1's full
    step with a profiled hot set; where the conversion fails it raises,
    as the JAX engine does; an unknown engine raises."""
    eng = dtt.BatchEngine(da, device="cpu", engine="hot")
    assert eng.engine == "hot" and eng.tables.kind == "MATOK"
    assert eng.hot_size > 0 and eng._kernel() is kt.transduce
    assert eng.tokenize_batch(texts) == [da.tokenize(t) for t in texts]
    with pytest.raises(RuntimeError, match="engine='hot' requires the "
                       "dense matrix layout but to_matrix\\(\\) failed"):
        dtt.BatchEngine(_no_matrix(da), device="cpu", engine="hot")
    with pytest.raises(ValueError, match="engine must be one of"):
        dtt.BatchEngine(da, device="cpu", engine="xla")


def test_general_on_matrix_matches_jax_general(texts):
    """``engine="general"`` on a ``.matok`` model runs K1's general form
    over the table and equals the JAX general machine."""
    tok = synth_tokenizer(N_ABBREV, SEED)
    eng = dtt.BatchEngine(tok, device="cpu", engine="general")
    assert eng.engine == "general" and eng.tables.kind == "MATOK"
    assert eng._kernel() is kt.transduce_general
    jeng = JaxEngine(jax_twin(tok), engine="general")
    entries, stops = _entries_stops(tok, texts)
    got, got_exits = eng.events_batch(texts, entries=entries, stops=stops,
                                      return_exits=True)
    want, want_exits = jeng.events_batch(texts, entries=entries, stops=stops,
                                         return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    assert eng.tokenize_batch(texts) == [tok.tokenize(t) for t in texts]


def test_sharded_general_equals_one_engine(da, texts, monkeypatch):
    """Each shard runs the engine's form: two CPU shards of a general
    engine over the double array equal one engine, events, exits and
    corpus counters."""
    calls = []

    def general(*args, **kw):
        calls.append(args[0].kind)
        return kt.transduce_general(*args, **kw)

    def full(*args, **kw):
        raise AssertionError("a general shard launched the full form")

    monkeypatch.setattr(engine_mod, "transduce_general", general)
    monkeypatch.setattr(engine_mod, "transduce", full)
    one = dtt.BatchEngine(da, device="cpu", engine="general")
    seng = dtt.ShardedEngine(da, devices=["cpu"] * 2, engine="general")
    assert seng.engine == "general" and seng.tables.kind == "DATOK"
    entries, stops = _entries_stops(da, texts)
    want = one.events_batch(texts, entries=entries, stops=stops,
                            return_exits=True)
    calls.clear()
    got = seng.events_batch(texts, entries=entries, stops=stops,
                            return_exits=True)
    assert calls == ["DATOK", "DATOK"]  # one launch a shard
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    stats = seng.corpus_stats(texts)
    evs = one.events_batch(texts)
    kinds = [k for ev in evs for k, _, _ in ev]
    assert (stats["tokens"], stats["sentences"], stats["texts"]) == (
        kinds.count(1), kinds.count(2), kinds.count(3))
    assert stats["chars"] == sum(len(t) for t in texts)


# ---- the wrapper --------------------------------------------------------------

def _small_args(tok, B=4, L=8):
    return [tables_from_tokenizer(tok, "cpu"),
            torch.zeros((B, L), dtype=torch.int32),
            torch.full((B,), L, dtype=torch.int32),
            torch.ones(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.bool), 2 * L + 64]


def test_wrapper_refuses_what_k1_does_not_take(da):
    """The full form refuses a double array on every device and in the
    host build; the general form refuses one of 2^28 cells or more."""
    args = _small_args(da)
    with pytest.raises(ValueError, match="full form needs the dense matrix"):
        kt.transduce(*args)
    with pytest.raises(ValueError, match="full form needs the dense matrix"):
        kt.transduce_host(*args, form="full")
    big = dataclasses.replace(args[0], n_cells=kt.DA_MAX_CELLS)
    for fn in (kt.transduce_general,
               lambda *a: kt.transduce_host(*a, form="general")):
        with pytest.raises(ValueError, match="2\\^28"):
            fn(big, *args[1:])
    # just below the limit passes the check (and runs: the plain machine)
    before = kt.transduce_general.launches
    out = kt.transduce_general(*args)
    assert out[2].sum() == 0 and kt.transduce_general.launches == before


def _without_pairs(tb, how):
    """``tb`` with its K1 form of the cells missing or malformed."""
    return {
        "no_pairs": lambda: dataclasses.replace(tb, pairs=None),
        "no_hop": lambda: dataclasses.replace(tb, hop=None),
        "short_pairs": lambda: dataclasses.replace(tb, pairs=tb.pairs[:-1]),
        "hop_columns": lambda: dataclasses.replace(tb, hop=tb.hop[:, :1]),
        "strided_pairs": lambda: dataclasses.replace(
            tb, pairs=torch.stack([tb.pairs[:, 0], tb.pairs[:, 1]], 1)
            .t().contiguous().t()),
        "strided_hop": lambda: dataclasses.replace(
            tb, hop=tb.hop.t().contiguous().t()),
    }[how]()


@pytest.mark.parametrize("how", ["no_pairs", "no_hop", "short_pairs",
                                 "hop_columns", "strided_pairs",
                                 "strided_hop"])
def test_wrapper_refuses_a_double_array_without_its_pairs(da, how):
    """K1 reads a double array's (word, check) pairs and hop table as
    contiguous (n_cells, 2) and (m, 2) words: the general form and the
    host build refuse tables without them, on every device; the same
    values, contiguous, run."""
    args = _small_args(da)
    bad = _without_pairs(args[0], how)
    for fn in (kt.transduce_general,
               lambda *a: kt.transduce_host(*a, form="general")):
        with pytest.raises(ValueError, match="pairs and hop table"):
            fn(bad, *args[1:])
    if how.startswith("strided"):
        fixed = dataclasses.replace(bad, pairs=bad.pairs.contiguous(),
                                    hop=bad.hop.contiguous())
        assert _same(
            _masked(kt.transduce_host(fixed, *args[1:], form="general")),
            _masked(kt.transduce_general(*args)))


def test_package_exports_every_jax_name():
    """Every name of ``datok_tpu.__all__`` is in the port's
    ``__all__`` and resolves there, ``AdaptiveEngine`` included."""
    assert [n for n in datok_tpu.__all__ if not hasattr(dtt, n)] == []
    assert set(datok_tpu.__all__) <= set(dtt.__all__)
    assert dtt.AdaptiveEngine is dtt.runtime.adaptive.AdaptiveEngine


# ---- K1 on a card -------------------------------------------------------------

@pytest.mark.cuda
def test_k1_da_matches_plain_machine_on_card(da, texts):
    """K1's double-array form against the plain machine on the card,
    every quantity, with the hop table as built and spread over many
    entries, and the engine launching only that form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    dev = torch.device("cuda")
    meta, lengths, _ = SymbolEncoder(da).encode_batch(texts)
    entries, stops = _entries_stops(da, texts)
    args = (tables_from_tokenizer(da, dev),
            *(torch.from_numpy(x).to(dev)
              for x in (meta, lengths, entries, stops)),
            2 * meta.shape[1] + 64)
    plain = run_machine(*args, form="general")
    keep = (torch.arange(plain[0].shape[1], device=dev)[None, :]
            < plain[1][:, None])
    for spread in (0, SPREAD):
        before = kt.transduce_general.launches
        k1 = kt.transduce_general(tables_from_tokenizer(da, dev, spread),
                                  *args[1:])
        torch.cuda.synchronize()
        assert kt.transduce_general.launches == before + 1
        assert torch.equal(torch.where(keep, k1[0], 0), plain[0])
        assert _same(k1[1:], plain[1:])
    eng = dtt.BatchEngine(da, device=dev, engine="general")
    full, gen = kt.transduce.launches, kt.transduce_general.launches
    assert eng.tokenize_batch(texts) == [da.tokenize(t) for t in texts]
    assert kt.transduce.launches == full
    assert kt.transduce_general.launches == gen + 1
