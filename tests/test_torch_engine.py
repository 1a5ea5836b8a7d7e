"""The whole slice: ``datok_tpu_torch.BatchEngine`` on the CPU against
the JAX Pallas engine (interpret mode) and the scalar oracle.

Outputs are integers and bytes, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu_torch import BatchEngine
from datok_tpu_torch.fsa.automaton import Automaton, Edge
from datok_tpu_torch.fsa.matrix import MatrixTokenizer
from datok_tpu_torch.kernels.transduce import transduce_host
from datok_tpu_torch.runtime import decode
from datok_tpu_torch.runtime import engine as engine_mod
from datok_tpu_torch.runtime.hot import hot_capacity
from datok_tpu_torch.runtime.machine import MAX_SEGMENT
from datok_tpu_torch.runtime.oracle import transduce_events
from datok_tpu_torch.runtime.rep import with_hot
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 380, 5
EDGE = [
    "", "x -", "3.", "a → b", "œ~", "Der Mann.\x04", "z.B. Weststr. 3.\x04",
    "Er sagte: „gut“ … und ging.\x04Neu-\x04", "Ende.\x04\n", "\x04\x04",
    "  -x --y 3,50 14:30 5.9.2018.", "ab~c þ ¤ 中文 😀!",
]


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(N_ABBREV, SEED)


@pytest.fixture(scope="module")
def texts(tok):
    rng = np.random.default_rng(SEED)
    return synth_text(tok, 52, [int(x) for x in rng.integers(0, 300, 52)],
                      seed=SEED) + EDGE


@pytest.fixture(scope="module")
def pallas(tok):
    return JaxEngine(jax_twin(tok), engine="pallas", pallas_interpret=True,
                     kernel_bl=128, kernel_k=16)


@pytest.fixture(scope="module")
def pallas_out(pallas, texts):
    return pallas.tokenize_batch(texts)


@pytest.mark.parametrize("kind", ["matok", "datok"])
def test_tokenize_batch_matches_pallas_and_oracle(tok, texts, pallas_out, kind):
    model = tok if kind == "matok" else synth_datok(N_ABBREV, SEED)
    out = BatchEngine(model, device="cpu").tokenize_batch(texts)
    assert out == [model.tokenize(t) for t in texts]
    assert out == pallas_out


def _entries_stops(tok, texts):
    """Non-root entries (exit contexts of a first run, shuffled) and
    cuts on the texts that end in EOT, as the stream splitter sends."""
    _, exits = BatchEngine(tok, device="cpu").events_batch(texts, return_exits=True)
    rng = np.random.default_rng(SEED + 1)
    entries = exits[rng.permutation(len(texts))].astype(np.int32)
    stops = np.array([t.endswith("\x04") for t in texts])
    return entries, stops


def test_events_batch_entries_stops_match_pallas(tok, texts, pallas):
    entries, stops = _entries_stops(tok, texts)
    assert stops.any()
    got, got_exits = BatchEngine(tok, device="cpu").events_batch(
        texts, entries=entries, stops=stops, return_exits=True)
    want, want_exits = pallas.events_batch(
        texts, entries=entries, stops=stops, return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)


def test_forced_bad_lanes_repaired_exactly(tok, texts):
    """A tiny step budget leaves lanes unfinished on the device; the
    host repair still gives the oracle's bytes, cut lanes included."""
    starved = BatchEngine(tok, device="cpu", steps_factor=0.05)
    meta, lengths, _ = starved.encoder.encode_batch(texts)
    bad = starved.run_raw(meta, lengths)[2]
    assert bad.sum() > len(texts) // 2
    assert starved.tokenize_batch(texts) == [tok.tokenize(t) for t in texts]
    entries, stops = _entries_stops(tok, texts)
    full = BatchEngine(tok, device="cpu")
    got, got_exits = starved.events_batch(texts, entries=entries, stops=stops,
                                          return_exits=True)
    want, want_exits = full.events_batch(texts, entries=entries, stops=stops,
                                         return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits[stops], want_exits[stops])


def test_segment_over_max_raises(tok):
    eng = BatchEngine(tok, device="cpu")
    meta = np.zeros((1, MAX_SEGMENT + 1), dtype=np.int32)
    with pytest.raises(ValueError, match="packed-event limit"):
        eng.run_raw_device(meta, np.array([1], dtype=np.int32))


@pytest.mark.parametrize("lanes", ["defaults", "given"])
def test_run_raw_device_takes_tensors_on_its_device(tok, texts, lanes):
    """Tensors already on the engine's device go to the launch as they
    are and give the same ``(events, counts, bad, state, steps)`` as the
    numpy arrays they hold; a tensor on another device raises."""
    eng = BatchEngine(tok, device="cpu")
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    entries, stops = (_entries_stops(tok, texts) if lanes == "given"
                      else (None, None))
    want = eng.run_raw_device(meta, lengths, entries, stops)
    as_tensor = [None if x is None else torch.from_numpy(x)
                 for x in (meta, lengths, entries, stops)]
    got = eng.run_raw_device(*as_tensor)
    masks = [torch.arange(r[0].shape[1])[None, :] < r[1][:, None]
             for r in (want, got)]
    assert torch.equal(want[0] * masks[0], got[0] * masks[1])
    for w, g in zip(want[1:], got[1:]):
        assert torch.equal(w, g)
    assert want[2].sum() == 0 and want[1].sum() > 0
    launched = []
    real = eng._launch
    eng._launch = lambda *a: launched.append(a) or real(*a)
    eng.run_raw_device(*as_tensor)
    assert launched[0][0] is as_tensor[0] and launched[0][1] is as_tensor[1]
    on_meta = torch.from_numpy(meta).to("meta")
    with pytest.raises(ValueError, match="meta is on meta"):
        eng.run_raw_device(on_meta, lengths)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_decoder_fails_loud_and_paths_agree(monkeypatch, path):
    ev = np.array([[1 | 1 << 2 | 3 << 17, 2 | 3 << 2 | 3 << 17, 0],
                   [3 | 7 << 2 | 7 << 17, 0, 0]], dtype=np.int32)
    counts = np.array([2, 1], dtype=np.int32)
    want = [[(1, 1, 3), (2, 3, 3)], [(3, 7, 7)]]
    if path == "numpy":
        monkeypatch.setattr(decode, "native_decode_events", lambda *a: None)
    assert decode.decode_events_compact(ev, counts) == want
    with pytest.raises(ValueError, match="narrower than counts"):
        decode.decode_events_flat(ev, np.array([4, 0], dtype=np.int32))


def _big_tok() -> MatrixTokenizer:
    """A >2^15-state model (the shape of tests/test_injection_limit.py's
    ``_big_tok``): root, '.' state and a long 'a'-chain at the top of
    the id range, each chain state with an ε bound back to the root."""
    base, n = 32600, 200
    S = base + n - 1
    auto = Automaton()
    auto.epsilon, auto.unknown, auto.identity = 1, 2, 3
    auto.final = -1
    auto.sigma_rev = {4: "a", 5: " ", 6: "."}
    auto.sigma_count = 6
    auto.state_count = S
    auto.transitions = [None] * (S + 2)
    auto.transitions[1] = {
        4: Edge(4, 4, base),
        5: Edge(5, 1, 1, nontoken=True),
        6: Edge(6, 6, 2),
    }
    auto.transitions[2] = {1: Edge(1, 0, 1, tokenend=True)}
    for i in range(n):
        s = base + i
        auto.transitions[s] = {
            4: Edge(4, 4, s + 1 if i + 1 < n else s),
            1: Edge(1, 0, 1, tokenend=True),
        }
    return MatrixTokenizer.from_automaton(auto)


def test_big_model_matches_oracle():
    tok = _big_tok()
    assert tok.state_count >= 1 << 15
    texts = ["a" * 180 + " aa.", "aaa a. " + "a" * 170 + ".",
             "a a. " + "a" * 150 + " a.", "", ". a"]
    assert (BatchEngine(tok, device="cpu").tokenize_batch(texts)
            == [tok.tokenize(t) for t in texts])


def test_cuda_without_card_raises(tok):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchEngine(tok, device="cuda")


@pytest.mark.parametrize("surface", ["BatchEngine", "run_corpus_distributed"])
def test_no_device_named_means_cuda(tok, tmp_path, monkeypatch, surface):
    """Entry points run on the card unless the caller names a device: a
    call naming neither an engine nor a device asks for "cuda", which
    raises without a card (the stream surfaces and the corpus runner
    are held to this in their own test files)."""
    import datok_tpu_torch as dtt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "BatchEngine": lambda: BatchEngine(tok),
        "run_corpus_distributed": lambda: dtt.run_corpus_distributed(
            tok, [], str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[surface]()


def test_empty_wave(tok):
    eng = BatchEngine(tok, device="cpu")
    assert eng.events_batch([]) == []
    evs, exits = eng.events_batch([], return_exits=True)
    assert evs == [] and exits.shape == (0,)


def test_full_size_synthetic_model_has_de_shape():
    """The default fixture is the DE model's shape (BASELINE.md:18:
    ~18,400 states x 171 symbols, ~12.6 MB of u32 cells) and runs the
    slice exactly."""
    tok = synth_tokenizer()
    assert 18_300 <= tok.state_count <= 18_500
    assert len(tok.array) == 171 * (tok.state_count + 1)
    assert abs(tok.array.nbytes - 12.6e6) < 0.1e6
    texts = synth_text(tok, 6, 200, seed=1) + ["z.B. bzw. Abk. usw.\x04"]
    assert (BatchEngine(tok, device="cpu").tokenize_batch(texts)
            == [tok.tokenize(t) for t in texts])


# ---- K1's host build on the engine's path, with hot sets --------------------

def _engine(tok, texts, hot, **kw):
    """An engine with the hot set ``hot``: 0, 1, 8 or auto states as the
    engine chooses them, or (``"skip_top"``) 64 states that leave out
    the 8 the texts visit most."""
    if hot != "skip_top":
        return BatchEngine(tok, device="cpu", hot_size=hot, **kw)
    eng = BatchEngine(tok, device="cpu", hot_size=0, **kw)
    counter = {}
    for t in texts:
        transduce_events(tok, t, state_counter=counter)
    ranked = sorted(counter, key=lambda s: -counter[s])
    eng.tables = with_hot(eng.tables, ranked[8:72])
    return eng


@pytest.mark.parametrize("hot", [0, 1, 8, "auto", "skip_top"])
def test_host_build_final_bytes_match_pallas_and_oracle(monkeypatch, tok, texts,
                                                        pallas, pallas_out,
                                                        hot):
    """The engine's path with K1's C++ step (g++ host build, hot rows
    and tags) in the place of the device machine: every lane's final
    bytes, forced ``bad`` lanes repaired on the host, and events and
    exit contexts from non-root entries with cuts equal to the Pallas
    engine's and the oracle's."""
    calls = []

    def host(*args, **kw):
        calls.append(args[0].hot)
        return transduce_host(*args, **kw)

    entries, stops = _entries_stops(tok, texts)
    monkeypatch.setattr(engine_mod, "transduce", host)
    want, want_exits = pallas.events_batch(texts, entries=entries, stops=stops,
                                           return_exits=True)
    for factor in (2.0, 0.05):
        eng = _engine(tok, texts, hot, steps_factor=factor)
        assert eng.tokenize_batch(texts) == pallas_out
        assert pallas_out == [tok.tokenize(t) for t in texts]
        got, got_exits = eng.events_batch(texts, entries=entries, stops=stops,
                                          return_exits=True)
        assert got == want
        if factor == 2.0:
            np.testing.assert_array_equal(got_exits, want_exits)
        else:
            meta, lengths, _ = eng.encoder.encode_batch(texts)
            assert eng.run_raw(meta, lengths)[2].sum() > len(texts) // 2
            np.testing.assert_array_equal(got_exits[stops], want_exits[stops])
    assert calls and all((h is None) == (hot == 0) for h in calls)


def test_hot_size_choice_and_cold_share(tok, texts):
    """The default keeps no hot set; "auto" takes the JAX auto size
    capped at one block's shared memory; an int takes that many; more
    than fits raises; a double array runs as its matrix, with a hot set
    when asked.  The engine counts cold steps per launch and since
    ``reset_cold``."""
    cap = hot_capacity(171)
    assert cap == 339
    default = BatchEngine(tok, device="cpu")
    assert default.hot_size == 0 and default.tables.hot is None
    auto = BatchEngine(tok, device="cpu", hot_size="auto")
    assert auto.hot_size == cap == auto.tables.hot.H
    assert auto.tables.hot.states[0] == 1 and auto.tables.hot.root_h == 1
    assert BatchEngine(tok, device="cpu", hot_size=8).hot_size == 8
    assert BatchEngine(tok, device="cpu", hot_size=0).tables.hot is None
    with pytest.raises(ValueError, match="shared memory"):
        BatchEngine(tok, device="cpu", hot_size=cap + 1)
    da = BatchEngine(synth_datok(60, 1), device="cpu", hot_size="auto")
    assert da.tables.kind == "MATOK" and da.hot_size > 0
    assert auto.last_cold_share is None and auto.cold_share == 0.0
    auto.events_batch(texts[:20])
    first = auto.last_cold_share
    auto.events_batch(texts[20:])
    assert 0 <= first < 0.1 and 0 <= auto.last_cold_share < 0.1
    both = auto.cold_share
    assert min(first, auto.last_cold_share) <= both <= max(
        first, auto.last_cold_share)
    auto.reset_cold()
    assert auto.cold_share == 0.0
    none = BatchEngine(tok, device="cpu", hot_size=0)
    none.events_batch(texts)
    assert none.cold_share > 0.9
