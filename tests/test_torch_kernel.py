"""K1's module against the TPU kernel it replaces.

* The wrapper ``datok_tpu_torch.kernels.transduce.transduce`` with CPU
  tensors (its plain version) against the JAX Pallas kernel
  (``pallas_engine._make_kernel`` through ``BatchEngine(engine="pallas",
  pallas_interpret=True)``, as tests/test_pallas_engine.py runs it).
  Step counts and which lanes go ``bad`` are budget artefacts of either
  machine, so events and exit state are compared on lanes that finish
  in both runs.
* K1's C++ step header built for the host with g++: its general form
  against the JAX general machine (exactly, ``bad`` lanes included),
  its full form (the engine's) against the Pallas run.
* The host build with K1's hot set (runtime/hot.py), at hot sets of
  size 0, 1, 8 and auto and one that leaves out the states the texts
  visit most, in the same two pairings, and against the plain machine,
  cold-step counts included.
* The tagged tables (``pack_hot``), and ``profile_hot_states`` against
  the JAX function.
* ``tables_from_tokenizer`` against ``make_rep(tok).tables``, byte for
  byte.
* K1 itself against the plain machine on a card (skipped without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datok_tpu.runtime import jax_engine as JE
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu.runtime.jax_engine import _run_machine, make_rep
from datok_tpu_torch import BatchEngine
from datok_tpu_torch.kernels.transduce import transduce, transduce_host
from datok_tpu_torch.runtime import hot as H
from datok_tpu_torch.runtime.decode import (decode_events_batch,
                                            decode_events_compact)
from datok_tpu_torch.runtime.encode import SymbolEncoder
from datok_tpu_torch.runtime.machine import run_machine
from datok_tpu_torch.runtime.oracle import transduce_events
from datok_tpu_torch.runtime.rep import tables_from_tokenizer, with_hot
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 430, 1  # ~1,650 states
EDGE = ["", "x -", "3.", "a → b", "œ~", "Mann.\x04z.B. Neu-\x04", "ab~c 中 😀!"]


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(N_ABBREV, SEED)


@pytest.fixture(scope="module")
def pallas(tok):
    return JaxEngine(jax_twin(tok), engine="pallas", pallas_interpret=True,
                     kernel_bl=128, kernel_k=16)


def _texts(tok):
    rng = np.random.default_rng(SEED)
    return synth_text(tok, 57, [int(x) for x in rng.integers(0, 300, 57)],
                      seed=SEED) + EDGE


@pytest.fixture(scope="module")
def wave(tok, pallas):
    meta, lengths, _ = pallas.encoder.encode_batch(_texts(tok))
    return meta, lengths


@pytest.fixture(scope="module")
def pallas_root(pallas, wave):
    """The Pallas run from the root: (events, bad, state)."""
    ys, bad, n, state = pallas.run_raw(*wave)
    return decode_events_batch(ys, n, as_arrays=True), bad, state


def _inputs(tok, wave, case, root_state):
    meta, lengths = wave
    B = len(lengths)
    if case == "root":
        entries, stops = np.ones(B, np.int32), np.zeros(B, bool)
    else:
        # non-root entries: the Pallas run's exit contexts, shuffled
        rng = np.random.default_rng(SEED + 1)
        entries = root_state[:, 0][rng.permutation(B)].astype(np.int32)
        stops = rng.random(B) < 0.3
    return meta, lengths, entries, stops


def _port(fn, tok, meta, lengths, entries, stops, max_steps, tables=None,
          **form):
    ev, counts, bad, state, steps, _cold = fn(
        tables if tables is not None else tables_from_tokenizer(tok, "cpu"),
        torch.from_numpy(meta),
        torch.from_numpy(lengths), torch.from_numpy(entries),
        torch.from_numpy(stops), max_steps, **form,
    )
    evs = decode_events_compact(ev.numpy(), counts.numpy(), as_arrays=True)
    return evs, bad.numpy(), state.numpy(), steps.numpy()


def _assert_finished_lanes_equal(port, ref):
    (ev_p, bad_p, state_p), (ev_r, bad_r, state_r) = port, ref
    done = ~bad_p & ~bad_r
    assert done.mean() > 0.9
    for i in np.flatnonzero(done):
        np.testing.assert_array_equal(ev_p[i], ev_r[i], err_msg=f"lane {i}")
    np.testing.assert_array_equal(state_p[done], state_r[done])


@pytest.mark.parametrize("fn", [transduce, transduce_host],
                         ids=["wrapper_cpu", "host_build"])
@pytest.mark.parametrize("case", ["root", "entries_stops"])
def test_matches_pallas_kernel(tok, pallas, wave, pallas_root, fn, case):
    meta, lengths, entries, stops = _inputs(tok, wave, case, pallas_root[2])
    if case == "root":
        ref = pallas_root
    else:
        ys, bad, n, state = pallas.run_raw(meta, lengths, entries, stops)
        ref = decode_events_batch(ys, n, as_arrays=True), bad, state
    ev, bad, state, _ = _port(fn, tok, meta, lengths, entries, stops,
                              pallas.max_steps_for(meta.shape[1]))
    _assert_finished_lanes_equal((ev, bad, state), ref)


@pytest.mark.parametrize("budget", ["full", "tiny"])
@pytest.mark.parametrize("case", ["root", "entries_stops"])
def test_host_build_matches_jax_machine(tok, wave, pallas_root, case, budget):
    """The C++ general step against the JAX general machine: every lane
    and every quantity, unfinished lanes included."""
    meta, lengths, entries, stops = _inputs(tok, wave, case, pallas_root[2])
    max_steps = 2 * meta.shape[1] + 64 if budget == "full" else 40
    rep = make_rep(jax_twin(tok))
    ys, bad, n, state = _run_machine(
        tuple(jnp.asarray(t) for t in rep.tables), jnp.asarray(meta),
        jnp.asarray(lengths), jnp.asarray(entries), jnp.asarray(stops),
        eps=rep.eps, unknown=rep.unknown, identity=rep.identity, rep=rep,
        max_steps=max_steps,
    )
    ev_r = decode_events_batch(np.asarray(ys), int(n), as_arrays=True)
    ev, bad_h, state_h, steps_h = _port(transduce_host, tok, meta, lengths,
                                        entries, stops, max_steps,
                                        form="general")
    assert (budget == "tiny") == bool(np.asarray(bad).any())
    np.testing.assert_array_equal(bad_h, np.asarray(bad))
    np.testing.assert_array_equal(state_h, np.asarray(state))
    assert int(steps_h.max()) == int(n)
    for i, (a, b) in enumerate(zip(ev, ev_r)):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {i}")


@pytest.mark.parametrize("kind", ["matok", "datok"])
def test_tables_from_tokenizer_bytes(kind):
    tok = synth_tokenizer(60, 3) if kind == "matok" else synth_datok(60, 3)
    rep = make_rep(jax_twin(tok))
    tb = tables_from_tokenizer(tok, "cpu")
    assert tb.kind == tok.type()
    assert len(tb.arrays) == len(rep.tables)
    for got, want in zip(tb.arrays, rep.tables):
        assert got.dtype == torch.int32
        assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    # every array K1 reads is contiguous; a double array's check is the
    # second word of K1's (word, check) pairs, not a second copy
    if kind == "matok":
        assert tb.arrays[0].is_contiguous()
    else:
        base, check = tb.arrays
        assert (base.is_contiguous() and tb.pairs.is_contiguous()
                and tb.hop.is_contiguous())
        assert check.stride() == (2,)
        assert check.data_ptr() == tb.pairs.data_ptr() + 4
    assert (tb.S, tb.eps, tb.unknown, tb.identity, tb.n_cells) == (
        rep.S, rep.eps, rep.unknown, rep.identity, rep.n_cells)
    if kind == "matok":
        assert tb.max_sym == rep.max_sym
    else:
        assert tb.size == rep.size


def _good_args(tok, B=4, L=8):
    return [tables_from_tokenizer(tok, "cpu"),
            torch.zeros((B, L), dtype=torch.int32),
            torch.full((B,), L, dtype=torch.int32),
            torch.ones(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.bool), 2 * L + 64]


@pytest.mark.parametrize("bad_arg", ["meta_dtype", "lengths_shape",
                                     "stops_dtype", "noncontiguous"])
def test_wrapper_rejects_bad_inputs(tok, bad_arg):
    args = _good_args(tok)
    if bad_arg == "meta_dtype":
        args[1] = args[1].long()
        err = TypeError
    elif bad_arg == "lengths_shape":
        args[2] = args[2][:2]
        err = ValueError
    elif bad_arg == "stops_dtype":
        args[4] = args[4].to(torch.int32)
        err = TypeError
    else:
        args[1] = torch.zeros((8, 4), dtype=torch.int32).t()
        err = ValueError
    with pytest.raises(err):
        transduce(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("hot_size", [0, "auto"])
def test_k1_matches_plain_machine_on_card(tok, hot_size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    rng = np.random.default_rng(SEED)
    texts = synth_text(tok, 200, [int(x) for x in rng.integers(0, 300, 200)],
                       seed=SEED) + EDGE
    meta, lengths, _ = SymbolEncoder(tok).encode_batch(texts)
    B = len(texts)
    dev = torch.device("cuda")
    args = (BatchEngine(tok, dev, hot_size=hot_size).tables,
            torch.from_numpy(meta).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.ones(B, dtype=torch.int32, device=dev),
            torch.from_numpy(rng.random(B) < 0.3).to(dev),
            2 * meta.shape[1] + 64)
    before = transduce.launches
    k1 = transduce(*args)
    torch.cuda.synchronize()
    assert transduce.launches == before + 1
    plain = run_machine(*args)
    counts = plain[1]
    keep = torch.arange(k1[0].shape[1], device=dev)[None, :] < counts[:, None]
    assert torch.equal(torch.where(keep, k1[0], 0), plain[0])
    for a, b in zip(k1[1:], plain[1:]):
        assert torch.equal(a, b)


# ---- the hot set ------------------------------------------------------------

HOT = [0, 1, 8, "auto", "skip_top"]


@pytest.fixture(scope="module")
def hot_tables(tok):
    """The tables the host build runs with: hot sets of 0, 1, 8 and
    auto states as the engine chooses them, and 64 states that leave
    out the 8 the wave's texts visit most (the root among them)."""
    counter = {}
    for t in _texts(tok):
        transduce_events(tok, t, state_counter=counter)
    ranked = sorted(counter, key=lambda s: -counter[s])
    assert ranked.index(1) < 8
    out = {k: BatchEngine(tok, "cpu", hot_size=k).tables for k in HOT[:4]}
    out["skip_top"] = with_hot(tables_from_tokenizer(tok, "cpu"), ranked[8:72])
    assert [0 if out[k].hot is None else out[k].hot.H for k in HOT] == [
        0, 1, 8, H.hot_capacity(171), 64]
    return out


@pytest.fixture(scope="module")
def pallas_entries(tok, pallas, wave, pallas_root):
    """The Pallas run from non-root entries with cuts."""
    meta, lengths, entries, stops = _inputs(tok, wave, "entries_stops",
                                            pallas_root[2])
    ys, bad, n, state = pallas.run_raw(meta, lengths, entries, stops)
    return decode_events_batch(ys, n, as_arrays=True), bad, state


@pytest.mark.parametrize("case", ["root", "entries_stops"])
@pytest.mark.parametrize("hot", HOT)
def test_hot_host_build_matches_pallas_kernel(tok, pallas, wave, pallas_root,
                                              pallas_entries, hot_tables, hot,
                                              case):
    meta, lengths, entries, stops = _inputs(tok, wave, case, pallas_root[2])
    ref = pallas_root if case == "root" else pallas_entries
    ev, bad, state, _ = _port(transduce_host, tok, meta, lengths, entries,
                              stops, pallas.max_steps_for(meta.shape[1]),
                              tables=hot_tables[hot])
    _assert_finished_lanes_equal((ev, bad, state), ref)


@pytest.fixture(scope="module")
def jax_general(tok, wave, pallas_root):
    """The JAX general machine per (case, budget), run once each."""
    runs = {}

    def run(case, budget):
        if (case, budget) not in runs:
            meta, lengths, entries, stops = _inputs(tok, wave, case,
                                                    pallas_root[2])
            max_steps = 2 * meta.shape[1] + 64 if budget == "full" else 40
            rep = make_rep(jax_twin(tok))
            ys, bad, n, state = _run_machine(
                tuple(jnp.asarray(t) for t in rep.tables), jnp.asarray(meta),
                jnp.asarray(lengths), jnp.asarray(entries),
                jnp.asarray(stops), eps=rep.eps, unknown=rep.unknown,
                identity=rep.identity, rep=rep, max_steps=max_steps,
            )
            runs[case, budget] = (
                (meta, lengths, entries, stops, max_steps),
                decode_events_batch(np.asarray(ys), int(n), as_arrays=True),
                np.asarray(bad), int(n), np.asarray(state))
        return runs[case, budget]

    return run


@pytest.mark.parametrize("budget", ["full", "tiny"])
@pytest.mark.parametrize("case", ["root", "entries_stops"])
@pytest.mark.parametrize("hot", HOT)
def test_hot_host_build_matches_jax_machine(tok, jax_general, hot_tables,
                                            hot, case, budget):
    """The general step: every lane and every quantity, unfinished lanes
    included, and the cold-step count equal to the plain machine's on
    the same tables."""
    args, ev_r, bad, n, state = jax_general(case, budget)
    meta, lengths, entries, stops, max_steps = args
    tb = hot_tables[hot]
    out = transduce_host(tb, torch.from_numpy(meta), torch.from_numpy(lengths),
                         torch.from_numpy(entries), torch.from_numpy(stops),
                         max_steps, form="general")
    ev = decode_events_compact(out[0].numpy(), out[1].numpy(), as_arrays=True)
    np.testing.assert_array_equal(out[2].numpy(), bad)
    np.testing.assert_array_equal(out[3].numpy(), state)
    assert int(out[4].max()) == n
    for i, (a, b) in enumerate(zip(ev, ev_r)):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {i}")
    plain = run_machine(tb, torch.from_numpy(meta), torch.from_numpy(lengths),
                        torch.from_numpy(entries), torch.from_numpy(stops),
                        max_steps, form="general")
    assert out[5].tolist() == plain[5].tolist()
    n_cold, n_steps = out[5].tolist()
    assert n_steps == int(out[4].sum())
    if tb.hot is None:
        assert n_cold > 0.9 * n_steps


def test_cold_share_follows_the_hot_set(tok, wave, hot_tables):
    """More hot states, fewer cold steps; the auto set, profiled on
    other texts, serves most steps of these (their abbreviations are the
    synthetic model's own), and leaving out the most visited states
    costs most of that."""
    meta, lengths = wave
    B = len(lengths)
    share = {}
    total = torch.zeros(2, dtype=torch.int64)
    for k in HOT:
        cold = transduce_host(hot_tables[k], torch.from_numpy(meta),
                              torch.from_numpy(lengths),
                              torch.ones(B, dtype=torch.int32),
                              torch.zeros(B, dtype=torch.bool),
                              2 * meta.shape[1] + 64, cold_total=total)[5]
        share[k] = cold[0].item() / cold[1].item()
    assert share[0] > share[1] > share[8] > share["auto"]
    assert share["auto"] < 0.1
    assert share["skip_top"] > 10 * share["auto"]
    assert total[1].item() == len(HOT) * cold[1].item()


def test_tagged_cells_untag_to_the_original(tok, hot_tables):
    """Every tagged cell, in the whole table and in the hot rows, clears
    to the original cell, and its tag is its target's hot index + 1."""
    array = np.asarray(tok.array, dtype=np.uint32)
    S, A = tok.state_count, len(array) // (tok.state_count + 1)
    for k in ("auto", "skip_top", 8):
        states = hot_tables[k].hot.states
        tagged, rows, hot_of = H.pack_hot(array, S, A, states)
        np.testing.assert_array_equal(H.untag(tagged), array)
        assert not (tagged & np.uint32(H.HOT_TAG_MASK))[array == 0].any()
        tag = (tagged >> np.uint32(H.HOT_SHIFT)) & np.uint32(0x3FF)
        target = array & np.uint32(0x7FFFFFFF)
        nz = array != 0
        np.testing.assert_array_equal(tag[nz], hot_of[target[nz]])
        np.testing.assert_array_equal(hot_of[states],
                                      np.arange(1, len(states) + 1))
        assert (hot_of != 0).sum() == len(states)
        want = array[(np.arange(A)[None, :] * S + states[:, None])]
        assert len(rows) % 4 == 0 and not rows[len(states) * A:].any()
        np.testing.assert_array_equal(
            H.untag(rows[:len(states) * A]).reshape(len(states), A), want)
        # the device copy holds the same bytes
        np.testing.assert_array_equal(
            hot_tables[k].hot.rows.numpy().view(np.uint32), rows)
        np.testing.assert_array_equal(
            hot_tables[k].hot.table.numpy().view(np.uint32), tagged)


def test_pack_hot_refuses_what_the_tags_cannot_hold(tok):
    """S >= 2^20, a cell with a tag bit (or bit 30) set, a state outside
    the table or too many states: no hot set, and the tables run
    without one (hot_size=0)."""
    S = 1 << 20
    array = np.zeros(3 * (S + 1), dtype=np.uint32)
    array[S + 1] = 2
    assert H.pack_hot(array, S, 3, [1, 2]) is None
    assert H.pack_hot(array, S - 1, 3, [1, 2]) is not None
    small = np.asarray(tok.array, dtype=np.uint32).copy()
    A = len(small) // (tok.state_count + 1)
    for bit in (20, 29, 30):
        bad = small.copy()
        bad[A] |= np.uint32(1 << bit)
        assert H.pack_hot(bad, tok.state_count, A, [1]) is None
    assert H.pack_hot(small, tok.state_count, A, [tok.state_count + 1]) is None
    assert H.pack_hot(small, tok.state_count, A, [1, 1]) is None
    assert H.pack_hot(small, tok.state_count, A,
                      np.arange(1, H.MAX_HOT + 2)) is None
    big = tables_from_tokenizer(tok, "cpu")
    big = type(big)(**{**vars(big), "S": S})
    assert with_hot(big, [1, 2]).hot is None


@pytest.mark.parametrize("limit", [8, 100, "auto"])
def test_profile_hot_states_matches_jax(tok, limit):
    texts = H.default_profile_texts(tok)
    got = H.profile_hot_states(tok, texts, limit)
    want = JE.profile_hot_states(jax_twin(tok), texts, limit)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1
