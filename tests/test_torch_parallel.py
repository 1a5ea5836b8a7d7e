"""The port's lane-sharded engine (``datok_tpu_torch.parallel.mesh``) on
CPU devices against the JAX ``ShardedEngine`` on the virtual 8-device
CPU mesh (general machine, and the Pallas kernel in interpret mode) and
against the oracle; counterparts of tests/test_parallel.py.

Outputs are integers and bytes, so every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import datok_tpu_torch as dtt
from datok_tpu.parallel.mesh import ShardedEngine as JaxSharded
from datok_tpu.parallel.mesh import balance_perm as jax_balance_perm
from datok_tpu_torch.kernels.transduce import outputs, transduce
from datok_tpu_torch.parallel.mesh import ShardedEngine, balance_perm
from datok_tpu_torch.runtime.machine import run_machine
from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 200, 11


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(N_ABBREV, SEED)


@pytest.fixture(scope="module")
def texts(tok):
    # 21 lanes, not a multiple of 8 shards: the padding runs; every
    # third text ends in EOT, as the stream splitter's cuts do
    rng = np.random.default_rng(SEED)
    docs = synth_text(tok, 19, [int(x) for x in rng.integers(0, 240, 19)],
                      seed=SEED)
    return [d + "\x04" * (i % 3 == 0) for i, d in enumerate(docs)] + [
        "", "Kurz.\x04Neu."]


@pytest.fixture(scope="module")
def sharded(tok):
    return ShardedEngine(tok, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_sharded(tok):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return JaxSharded(jax_twin(tok), mesh=Mesh(np.array(devs[:8]), ("data",)),
                      engine="general")


def test_sharded_matches_jax_and_oracle(tok, texts, sharded, jax_sharded):
    out = sharded.tokenize_batch(texts)
    assert out == [tok.tokenize(t) for t in texts]
    assert out == jax_sharded.tokenize_batch(texts)
    assert sharded.last_padded_lanes == 3


@pytest.mark.parametrize("as_arrays", [False, True])
def test_events_entries_stops_match_jax(tok, texts, sharded, jax_sharded,
                                        as_arrays):
    """Non-root entries (exit contexts of a first run, shuffled) and
    cuts on the texts that end in EOT, through the balanced lanes."""
    _, exits = dtt.BatchEngine(tok, device="cpu").events_batch(
        texts, return_exits=True)
    rng = np.random.default_rng(SEED + 1)
    entries = exits[rng.permutation(len(texts))].astype(np.int32)
    stops = np.array([t.endswith("\x04") for t in texts])
    assert stops.any()
    kw = dict(entries=entries, stops=stops, return_exits=True)
    got, got_exits = sharded.events_batch(texts, as_arrays=as_arrays, **kw)
    want, want_exits = jax_sharded.events_batch(texts, as_arrays=as_arrays,
                                                **kw)
    one, one_exits = dtt.BatchEngine(tok, device="cpu").events_batch(
        texts, as_arrays=as_arrays, **kw)
    if as_arrays:
        got, want, one = ([e.tolist() for e in x] for x in (got, want, one))
    assert got == want == one
    np.testing.assert_array_equal(got_exits, want_exits)
    np.testing.assert_array_equal(got_exits, one_exits)


def test_sharded_matches_pallas_interpret(tok):
    """The JAX multi-chip path with the fused kernel, in interpret mode
    on a 2-device mesh, against the port over two CPU shards."""
    jeng = JaxSharded(jax_twin(tok), mesh=Mesh(np.array(jax.devices()[:2]),
                                               ("data",)),
                      engine="pallas", pallas_interpret=True,
                      kernel_bl=128, kernel_k=16)
    assert jeng.engine == "pallas"
    texts = ["Der alte Mann.", "Zwei! Sätze?", "z.B. Weststr. 3.\x04Neu.",
             synth_text(tok, 1, 90, seed=3)[0], ""]
    out = ShardedEngine(tok, devices=["cpu"] * 2).tokenize_batch(texts)
    assert out == jeng.tokenize_batch(texts)
    assert out == [tok.tokenize(t) for t in texts]


def _block_max_steps(tok, texts, n):
    """Each block's most steps of one lane, from the port's own per-lane
    steps on the lanes as corpus_stats places them (balanced, padded)."""
    perm = balance_perm([len(t) for t in texts], n)
    lanes = [texts[i] for i in perm]
    lanes += [""] * ((-len(lanes)) % n)
    eng = dtt.BatchEngine(tok, device="cpu")
    meta, lengths, _ = eng.encoder.encode_batch(lanes)
    steps = eng.run_raw(meta, lengths)[3]
    return steps.reshape(n, -1).max(axis=1).tolist()


@pytest.mark.parametrize("balance", [True, False])
def test_corpus_stats_matches_jax(tok, texts, sharded, jax_sharded, balance):
    got = sharded.corpus_stats(texts, balance=balance)
    want = jax_sharded.corpus_stats(texts, balance=balance)
    assert got["fallback_lanes"] == want["fallback_lanes"] == 0
    for key in ("tokens", "sentences", "texts", "chars", "backtracks",
                "force_emits", "shards", "padded_lanes", "padded_fraction"):
        assert got[key] == want[key], key
    # step counts are budget artefacts of each machine: the port's shard
    # steps are its own lanes' steps, blockwise
    if balance:
        assert got["shard_steps"] == _block_max_steps(tok, texts, 8)
    steps = np.asarray(got["shard_steps"], dtype=np.int64)
    assert got["balance_efficiency"] == round(float(steps.mean())
                                              / steps.max(), 4)


def test_corpus_stats_counts_the_events(tok, texts, sharded):
    """The summed counters equal those of the single engine's decoded
    events (padding discounted), the chars those of the texts."""
    evs = dtt.BatchEngine(tok, device="cpu").events_batch(texts)
    kinds = [k for e in evs for k, _, _ in e]
    st = sharded.corpus_stats(texts)
    assert (st["tokens"], st["sentences"], st["texts"]) == (
        kinds.count(dtt.EV_TOKEN), kinds.count(dtt.EV_SENT),
        kinds.count(dtt.EV_TEXT))
    assert st["chars"] == sum(len(t) for t in texts)


def test_corpus_stats_scaling_fields(sharded):
    texts = ["Ein Satz. Und noch einer!\x04"] * 10
    stats = sharded.corpus_stats(texts)
    assert len(stats["shard_steps"]) == 8
    assert 0 < stats["balance_efficiency"] <= 1.0
    assert stats["padded_lanes"] == 6  # 10 -> 16 lanes at 8 shards
    assert stats["padded_fraction"] == round(6 / 16, 4)
    assert stats["texts"] == 10


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_balance_perm_matches_jax(n):
    rng = np.random.default_rng(n)
    for size in (0, 1, n, 3 * n + 1, 100):
        lens = rng.integers(0, 5000, size).tolist()
        got = balance_perm(lens, n)
        np.testing.assert_array_equal(got, jax_balance_perm(lens, n))
        assert sorted(got.tolist()) == list(range(size))


def test_balance_perm_properties():
    lens = [1000, 10, 10, 10, 900, 20, 800, 30, 700, 40, 50, 600,
            5, 500, 60, 70]
    perm = balance_perm(lens, 4)
    assert sorted(perm.tolist()) == list(range(16))
    # per-shard char totals within one max-doc of even
    tot = sum(lens)
    for s in range(4):
        shard = perm[s * 4 : (s + 1) * 4]
        work = sum(lens[i] for i in shard)
        assert abs(work - tot / 4) <= max(lens)


@pytest.mark.parametrize("n", [8, 3])
def test_sharded_wave_balancing_parity(tok, n):
    """The pipelined path on a sharded engine deals the lanes over the
    shards: output byte-identical to tokenize_stream, in input order,
    and per-shard step counts near even on a skewed batch (3 shards
    also pad the pipeline's 32 lanes inside the engine)."""
    eng = ShardedEngine(tok, devices=["cpu"] * n)
    # skewed: long docs clustered at the front
    docs = (["Lang und länger. " * 50 + "Ende gut!\x04"] * 4
            + [f"Kurz {i}.\x04" for i in range(28)])
    text = "".join(docs)
    a = dtt.tokenize_stream(tok, text, device="cpu").getvalue()
    b = dtt.tokenize_stream_pipelined(tok, text, engine=eng,
                                      pack_len=0).getvalue()
    assert a == b == tok.tokenize(text)
    steps = eng.last_shard_steps.astype(np.int64)
    assert len(steps) == n and steps.max() > 0
    # balanced: no shard does more than ~2x the mean (unbalanced
    # clustering would give one shard everything)
    assert steps.max() <= 2 * max(1.0, steps.mean())


def test_corpus_runner_on_sharded_engine(tok, tmp_path):
    files = []
    for i, t in enumerate(synth_text(tok, 5, 400, seed=SEED + 2)):
        files.append(tmp_path / f"d{i}.txt")
        files[-1].write_text(t, encoding="utf-8")
    eng = ShardedEngine(tok, devices=["cpu"] * 4)
    st = dtt.CorpusRunner(tok, str(tmp_path / "out"), engine=eng).run(
        [str(f) for f in files])
    assert st["done"] == 5
    for f in files:
        got = (tmp_path / "out" / (f.name + ".tok")).read_text(encoding="utf-8")
        assert got == tok.tokenize(f.read_text(encoding="utf-8"))


def test_cold_share_over_shards(tok, texts):
    """The hot set is replicated; the cold steps summed over the shards
    equal the single engine's on the same set (16 lanes on 4 shards: no
    padding; the sharded engine runs its own set, never a wave's)."""
    one = dtt.BatchEngine(tok, device="cpu", hot_size="auto", per_wave=False)
    four = ShardedEngine(tok, devices=["cpu"] * 4, hot_size="auto")
    assert four.hot_size == one.hot_size > 0
    assert four.events_batch(texts[:16]) == one.events_batch(texts[:16])
    assert four.last_cold_share == one.last_cold_share
    assert four.cold_share == one.cold_share > 0
    four.reset_cold()
    assert four.cold_share == 0.0


def test_out_views_take_row_blocks(tok, texts):
    """K1's wrapper with ``out=``: two launches write the row blocks of
    one set of outputs, equal to one run of the plain machine."""
    eng = dtt.BatchEngine(tok, device="cpu")
    meta, lengths, _ = eng.encoder.encode_batch(texts[:20])
    args = [torch.from_numpy(x) for x in
            (meta, lengths, np.ones(20, np.int32), np.zeros(20, bool))]
    steps = eng.max_steps_for(meta.shape[1])
    want = run_machine(eng.tables, *args, steps)
    buf = outputs(20, steps, torch.device("cpu"))
    cold = torch.zeros((2, 2), dtype=torch.int64)
    for lo, hi, c in ((0, 12, 0), (12, 20, 1)):
        view = tuple(o[lo:hi] for o in buf[:5]) + (cold[c],)
        got = transduce(eng.tables, *(a[lo:hi] for a in args), steps, out=view)
        assert all(g.data_ptr() == v.data_ptr() for g, v in zip(got, view))
    for g, w in zip(buf[:5], want[:5]):
        assert torch.equal(g, w)
    assert torch.equal(cold.sum(0), want[5])
    with pytest.raises(ValueError, match=r"out\[0\]"):
        transduce(eng.tables, *args, steps,
                  out=(buf[0][:, :-1],) + tuple(buf[1:]))


def test_shards_on_another_device_gather_their_columns(tok, texts):
    """Shards on a device other than the engine's first write outputs of
    their own, whose first ``max(counts)`` event columns and lane rows
    are copied into the first device's.  ``torch.device("cpu", 0)``
    compares unequal to ``"cpu"``, so on the CPU its shards take that
    path too."""
    eng = ShardedEngine(tok, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    one = dtt.BatchEngine(tok, device="cpu")
    got, got_exits = eng.events_batch(texts, return_exits=True)
    want, want_exits = one.events_batch(texts, return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    st = eng.corpus_stats(texts)
    assert st == ShardedEngine(tok, devices=["cpu"] * 4).corpus_stats(texts)
    assert st["padded_lanes"] == 3


def test_devices_checked(tok, monkeypatch):
    with pytest.raises(ValueError, match="empty"):
        ShardedEngine(tok, devices=[])
    with pytest.raises(ValueError, match="mix"):
        ShardedEngine(tok, devices=["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ShardedEngine(tok)
