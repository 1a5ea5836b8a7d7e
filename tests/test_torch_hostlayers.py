"""The port's own copies of the host layers against the JAX package's.

The port keeps a copy of every host module it needs (``fsa``, the
writer, events, encoder and oracle, the native library); this file holds
each copy against its original on seeded synthetic models: a matrix
model, its double-array twin and a matrix model without ``\\x04``.  The
port's objects go only to the port's code, the JAX package's only to
its own: a model crosses over as bytes, as a Foma file, or through
``tokenizer_from_arrays`` and ``jax_twin``.
"""

import gzip
import io

import numpy as np
import pytest

import datok_tpu.fsa.double_array as jda
import datok_tpu.fsa.foma as jfoma
import datok_tpu.fsa.io as jio
import datok_tpu.fsa.matrix as jmatrix
import datok_tpu.runtime.encode as jencode
import datok_tpu.runtime.events as jevents
import datok_tpu.runtime.oracle as joracle
import datok_tpu.runtime.writer as jwriter
import datok_tpu.utils.native as jnative

import datok_tpu_torch.fsa.double_array as pda
import datok_tpu_torch.fsa.foma as pfoma
import datok_tpu_torch.fsa.io as pio
import datok_tpu_torch.fsa.matrix as pmatrix
import datok_tpu_torch.runtime.encode as pencode
import datok_tpu_torch.runtime.events as pevents
import datok_tpu_torch.runtime.oracle as poracle
import datok_tpu_torch.runtime.writer as pwriter
import datok_tpu_torch.utils.native as pnative
from datok_tpu_torch.testing.synth import (synth_automaton, synth_datok,
                                           synth_text, synth_tokenizer)

from torch_twins import jax_twin

KINDS = ["matok", "datok", "no_eot"]
FIELDS = {
    "MATOK": ("array", "state_count", "epsilon", "unknown", "identity",
              "sigma_ascii", "sigma"),
    "DATOK": ("base", "check", "max_size", "final", "tokenend", "epsilon",
              "unknown", "identity", "sigma_ascii", "sigma"),
}


def _model(kind):
    if kind == "datok":
        return synth_datok(80, seed=5)
    return synth_tokenizer(80, seed=5, eot=kind != "no_eot")


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """(kind, the port's model, its JAX twin, texts)."""
    tok = _model(request.param)
    texts = synth_text(tok, 12, [0, 1, 7, 40, 90, 150, 200, 260, 333, 400,
                                 512, 640], seed=6)
    texts += ["Der alte Mann ging z.B. zur Weststr. 3.\x04Und dann?\n",
              "x\x04\x04 \x04", "€–„“” … ~^` 中😀 ok."]
    return request.param, tok, jax_twin(tok), texts


def _same_fields(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def test_loaders_give_equal_arrays_and_sigma(pair, tmp_path):
    """One file, both loaders: equal fields."""
    _kind, tok, _twin, _ = pair
    path = str(tmp_path / "m.bin")
    tok.save(path)
    mine, theirs = pio.load_tokenizer_file(path), jio.load_tokenizer_file(path)
    assert mine.type() == theirs.type() == tok.type()
    _same_fields(mine, theirs, FIELDS[tok.type()])
    # the arrays and sigma written are the ones read (a double array's
    # file keeps neither the builder's max_size nor tokenend)
    arrays = ("array",) if tok.type() == "MATOK" else ("base", "check")
    _same_fields(mine, tok, arrays + ("sigma", "sigma_ascii"))


def test_serialisation_is_byte_equal(pair):
    _kind, tok, twin, _ = pair
    data = tok.to_bytes()
    assert data == twin.to_bytes()
    # parse with each package, write again: the same bytes
    parse = {"MATOK": (pmatrix.parse_matrix, jmatrix.parse_matrix),
             "DATOK": (pda.parse_datok, jda.parse_datok)}[tok.type()]
    assert parse[0](data).to_bytes() == data
    assert parse[1](data).to_bytes() == data


def test_constants_equal():
    for name in ("MAMAGIC", "DAMAGIC", "VERSION", "EOT", "FIRSTBIT",
                 "SECONDBIT", "RESTBIT"):
        assert getattr(pio, name) == getattr(jio, name), name
    for name in ("SIMPLE", "TOKENS", "SENTENCES", "TOKEN_POS",
                 "SENTENCE_POS", "NEWLINE_AFTER_EOT"):
        assert getattr(pwriter, name) == getattr(jwriter, name), name


@pytest.mark.parametrize("data", [b"", b"a", b"\xc3\xa4x", b"\xe2\x82",
                                  b"\xff\xf0\x9f\x98\x80z", b"\x80abc"])
def test_read_rune_equal(data):
    for off in range(len(data)):
        assert pio.read_rune(data, off) == jio.read_rune(data, off)


# ---------------------------------------------------------------- Foma

def _foma_text(auto):
    """The synthetic automaton written as a Foma text FST."""
    special = {auto.epsilon: "@_EPSILON_SYMBOL_@",
               auto.unknown: "@_UNKNOWN_SYMBOL_@",
               auto.identity: "@_IDENTITY_SYMBOL_@",
               auto.tokenend: "@_TOKEN_BOUND_@"}
    out = io.StringIO()
    arcs = []
    for s in range(1, auto.state_count + 1):
        for e in (auto.transitions[s] or {}).values():
            if e.tokenend:
                i, o = auto.epsilon, auto.tokenend
            elif e.nontoken:
                i, o = e.in_sym, auto.epsilon
            else:
                i, o = e.in_sym, e.in_sym
            arcs.append(f"{s - 1} {i - 1} {o - 1} {e.end - 1} 0")
    out.write("##foma-net 1.0##\n##props##\n")
    out.write(f"2 {len(arcs)} {auto.state_count} {len(arcs)} 0 0 1 1 1 1 0 0 "
              "synth\n##sigma##\n")
    for n in range(1, auto.sigma_count):
        sym = special.get(n, auto.sigma_rev.get(n))
        if sym is None:
            continue
        out.write(f"{n - 1} {sym}\n")
    out.write("##states##\n")
    out.write("\n".join(arcs) + "\n-1 -1 -1 -1 -1\n##end##\n")
    return out.getvalue().encode("utf-8")


# Every line form the parser takes: 5, 4 (both kinds), 3 and 2 fields,
# a final state without arcs, the two-line newline symbol, a multi-char
# symbol whose arcs are dropped and a tokenend-accepting arc.
SMALL_FOMA = (
    "##foma-net 1.0##\n##props##\n"
    "2 9 4 12 2 0 1 1 1 1 0 0 small\n##sigma##\n"
    "0 @_EPSILON_SYMBOL_@\n1 @_UNKNOWN_SYMBOL_@\n2 @_IDENTITY_SYMBOL_@\n"
    "3 @_TOKEN_BOUND_@\n4 a\n5 b\n6  \n7 \n\n8 @MCS@\n9 .\n"
    "##states##\n"
    "0 4 4 1 0\n"
    "5 1\n"
    "6 0 0\n"
    "7 0 0\n"
    "8 8 1\n"
    "1 4 1 1\n"
    "5 5 1\n"
    "0 3 0\n"
    "3 3 2\n"
    "2 -1 -1 1\n"
    "3 9 9 0 1\n"
    "-1 -1 -1 -1 -1\n##end##\n"
).encode("utf-8")


def _same_automaton(a, b):
    for name in ("sigma_rev", "arc_count", "sigma_count", "state_count",
                 "epsilon", "unknown", "identity", "final", "tokenend",
                 "_sigma_mcs"):
        assert getattr(a, name) == getattr(b, name), name
    assert len(a.transitions) == len(b.transitions)
    for ta, tb in zip(a.transitions, b.transitions):
        if ta is None or tb is None:
            assert ta is tb
            continue
        assert {k: vars(e) for k, e in ta.items()} == \
            {k: vars(e) for k, e in tb.items()}


@pytest.mark.parametrize("which", ["small", "synth"])
def test_foma_parsing_equal(which, tmp_path):
    data = SMALL_FOMA if which == "small" else _foma_text(
        synth_automaton(60, seed=3)[0])
    path = tmp_path / "m.fst"
    with gzip.open(path, "wb") as fh:
        fh.write(data)
    mine, theirs = pfoma.load_foma_file(str(path)), jfoma.load_foma_file(str(path))
    _same_automaton(mine, theirs)
    m_tok = pmatrix.MatrixTokenizer.from_automaton(mine)
    j_tok = jmatrix.MatrixTokenizer.from_automaton(theirs)
    assert m_tok.to_bytes() == j_tok.to_bytes()
    assert pda.DaTokenizer.from_automaton(mine).to_bytes() == \
        jda.DaTokenizer.from_automaton(theirs).to_bytes()
    if which == "synth":
        text = "Der alte Mann ging z.B. zur Weststr. 3.\x04Und?"
        assert m_tok.tokenize(text) == j_tok.tokenize(text)


@pytest.mark.parametrize("props", ["2 1 1 1 0 0 0 1 1 1 0 0 x",
                                   "2 1 1 1 0 0 1 1 1 0 0 0 x"])
def test_foma_errors_equal(props):
    data = f"##foma-net 1.0##\n##props##\n{props}\n".encode()
    with pytest.raises(pfoma.FomaError) as mine:
        pfoma.parse_foma(io.BytesIO(data))
    with pytest.raises(jfoma.FomaError) as theirs:
        jfoma.parse_foma(io.BytesIO(data))
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------- runtime

def test_oracle_events_and_state_counter_equal(pair):
    _kind, tok, twin, texts = pair
    c_mine, c_theirs = {}, {}
    for text in texts:
        x_mine, x_theirs = [], []
        assert poracle.transduce_events(tok, text, state_counter=c_mine,
                                        exit_box=x_mine) == \
            joracle.transduce_events(twin, text, state_counter=c_theirs,
                                     exit_box=x_theirs)
        assert x_mine == x_theirs
        assert tok.tokenize(text) == twin.tokenize(text)
    assert c_mine == c_theirs and c_mine


def test_oracle_cut_walk_equal(pair):
    _kind, tok, twin, texts = pair
    text = max(texts, key=len)
    for start, stop in ((0, len(text) // 2), (0, len(text))):
        box = ([], [], [])
        jbox = ([], [], [])
        assert poracle.transduce_events(
            tok, text, start=start, stop_at=stop, registers_box=box[0],
            rewinds_box=box[1], exit_box=box[2]) == joracle.transduce_events(
            twin, text, start=start, stop_at=stop, registers_box=jbox[0],
            rewinds_box=jbox[1], exit_box=jbox[2])
        assert box == jbox


@pytest.mark.parametrize("flags", ["SIMPLE", "TOKENS", "SENTENCES",
                                   "TOKEN_POS", "SENTENCE_POS",
                                   "NEWLINE_AFTER_EOT"])
def test_writer_and_format_events_equal(pair, flags):
    _kind, tok, twin, texts = pair
    fl_mine = getattr(pwriter, flags) | pwriter.TOKENS
    fl_theirs = getattr(jwriter, flags) | jwriter.TOKENS
    for text in texts:
        evs = poracle.transduce_events(tok, text)
        assert pevents.format_events(evs, text, fl_mine) == \
            jevents.format_events(evs, text, fl_theirs)
        w_mine, w_theirs = pwriter.TokenWriter(fl_mine), jwriter.TokenWriter(fl_theirs)
        poracle.transduce(tok, text, w_mine)
        joracle.transduce(twin, text, w_theirs)
        assert w_mine.getvalue() == w_theirs.getvalue()


def test_encoder_meta_equal(pair):
    _kind, tok, twin, texts = pair
    enc, jenc = pencode.SymbolEncoder(tok), jencode.SymbolEncoder(twin)
    for text in texts:
        cp = pencode.text_to_codepoints(text)
        np.testing.assert_array_equal(cp, jencode.text_to_codepoints(text))
        np.testing.assert_array_equal(enc.encode(cp), jenc.encode(cp))
    for a, b in zip(enc.encode_batch(texts), jenc.encode_batch(texts)):
        if isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- native

def test_native_library_is_the_ports_own():
    lib = pnative.get_lib()
    assert lib is not None
    assert pnative._SRC.endswith("datok_tpu_torch/native/datok_host.cpp")
    assert pnative._SO.endswith("datok_tpu_torch/_build/libdatok_host.so")
    with open(pnative._SRC, "rb") as a, \
            open(jnative._SRC, "rb") as b:
        # the same code; only the first comment line names the package
        assert a.read().split(b"\n", 1)[1] == b.read().split(b"\n", 1)[1]


def test_native_encode_equal(pair):
    _kind, tok, twin, texts = pair
    enc, jenc = pencode.SymbolEncoder(tok), jencode.SymbolEncoder(twin)
    for text in texts:
        data = text.encode("utf-8")
        for a, b in zip(pnative.native_encode(enc, data),
                        jnative.native_encode(jenc, data)):
            np.testing.assert_array_equal(a, b)
    mine = pnative.native_encode_wave(enc, texts, threads=2)
    theirs = jnative.native_encode_wave(jenc, texts, threads=2)
    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])
    for x, y in zip(mine[2], theirs[2]):
        np.testing.assert_array_equal(x, y)


def _matrix_pair(pair):
    _kind, tok, _twin, texts = pair
    if tok.type() != "MATOK":
        tok = tok.to_matrix()
    return tok, jax_twin(tok), texts


def test_native_transduce_census_and_cut_walk_equal(pair):
    tok, twin, texts = _matrix_pair(pair)
    enc = pencode.SymbolEncoder(tok)
    hot = np.zeros(tok.state_count + 1, dtype=np.uint8)
    hot[1:20] = 1
    for text in texts:
        _cps, metas = pnative.native_encode(enc, text.encode("utf-8"))
        for entry in (1, 1 | (1 << 28) | (1 << 30)):
            x_mine, x_theirs = [], []
            got = pnative.native_transduce_events(
                tok, metas, as_array=True, entry_state=entry, exit_box=x_mine)
            want = jnative.native_transduce_events(
                twin, metas, as_array=True, entry_state=entry, exit_box=x_theirs)
            np.testing.assert_array_equal(got, want)
            assert x_mine == x_theirs
        c_mine, n_mine = pnative.native_state_census(tok, metas)
        c_theirs, n_theirs = jnative.native_state_census(twin, metas)
        np.testing.assert_array_equal(c_mine, c_theirs)
        assert n_mine == n_theirs
        assert pnative.native_cold_rate(tok, metas, hot) == \
            jnative.native_cold_rate(twin, metas, hot)
        half = len(metas) // 2
        assert pnative.native_cut_walk(tok, metas, 1, 0, half) == \
            jnative.native_cut_walk(twin, metas, 1, 0, half)


def test_native_decode_and_writer_equal(pair):
    tok, twin, texts = _matrix_pair(pair)
    enc = pencode.SymbolEncoder(tok)
    meta, lengths, cps = pnative.native_encode_wave(enc, texts, threads=2)
    rows = [pnative.native_transduce_events(tok, meta[i, :lengths[i]],
                                            as_array=True)
            for i in range(len(texts))]
    # packed (B, E) rows: kind | start<<2 | end<<17
    counts = np.array([len(r) for r in rows], dtype=np.int32)
    E = max(1, int(counts.max()))
    ev = np.zeros((len(texts), E), dtype=np.uint32)
    for i, r in enumerate(rows):
        ev[i, :len(r)] = (r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 17)).astype(np.uint32)
    tri = pnative.native_decode_events(ev, counts, workers=2)
    np.testing.assert_array_equal(tri, jnative.native_decode_events(ev, counts, workers=2))
    np.testing.assert_array_equal(tri, np.concatenate(rows))
    offs = np.zeros(len(texts), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offs[1:])
    flat = np.concatenate(cps).astype(np.int32)
    for flags in (pwriter.SIMPLE, pwriter.TOKENS | pwriter.TOKEN_POS
                  | pwriter.SENTENCE_POS):
        w_mine, w_theirs = pnative.NativeWriter(flags), jnative.NativeWriter(flags)
        w_mine.feed_wave(tri, counts, flat, offs, lengths, workers=2)
        w_theirs.feed_wave(tri, counts, flat, offs, lengths, workers=2)
        assert w_mine.getvalue() == w_theirs.getvalue()
        w_mine, w_theirs = pnative.NativeWriter(flags), jnative.NativeWriter(flags)
        w_mine.feed(rows[-1], cps[-1])
        w_theirs.feed(rows[-1], cps[-1])
        assert w_mine.getvalue() == w_theirs.getvalue()


def test_native_da_build_equal():
    auto = synth_automaton(60, seed=4)[0]
    for a, b in zip(pnative.native_da_build(auto), jnative.native_da_build(auto)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- arrays

def test_tokenizer_from_arrays_round_trips(pair):
    """JAX model -> port through its fields, and the port's own fields
    back: equal bytes and equal output."""
    _kind, tok, twin, texts = pair
    names = FIELDS[tok.type()]
    carried = pio.tokenizer_from_arrays(**{n: getattr(twin, n) for n in names})
    assert type(carried) is type(tok)
    assert carried.to_bytes() == twin.to_bytes() == tok.to_bytes()
    again = pio.tokenizer_from_arrays(**{n: getattr(carried, n) for n in names})
    _same_fields(again, tok, names)
    for text in texts:
        assert carried.tokenize(text) == twin.tokenize(text)
    # the arrays are copies, not views of the source
    arr = names[0]
    assert not np.shares_memory(getattr(carried, arr), getattr(twin, arr))


@pytest.mark.parametrize("bad", ["missing", "unknown"])
def test_tokenizer_from_arrays_rejects_other_fields(bad):
    tok = _model("matok")
    fields = {n: getattr(tok, n) for n in FIELDS["MATOK"]}
    if bad == "missing":
        del fields["epsilon"]
    else:
        fields["extra"] = 1
    with pytest.raises(ValueError):
        pio.tokenizer_from_arrays(**fields)
