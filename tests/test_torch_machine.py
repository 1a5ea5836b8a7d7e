"""The port's plain machine against the JAX general machine.

``datok_tpu_torch.runtime.machine.run_machine`` in its general form must
reproduce
``datok_tpu.runtime.jax_engine._run_machine`` exactly (every quantity
is an integer): per-lane events, exit-state rows, ``bad`` and step
counts, for matrix models and their ``.datok`` twins, from the root and
from non-root entry contexts, with cut lanes, and under a step budget
small enough to leave lanes unfinished.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datok_tpu.runtime.jax_engine import _run_machine, make_rep
from datok_tpu_torch.runtime.decode import (decode_events_batch,
                                            decode_events_compact)
from datok_tpu_torch.runtime.encode import SymbolEncoder
from datok_tpu_torch.runtime.machine import run_machine
from datok_tpu_torch.runtime.rep import tables_from_tokenizer
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 300, 11

# texts that reach the rarer step paths: residual flush at EOF ("x -"),
# EOF backtrack ("3."), identity→unknown retry ("a → b"), stale-ok
# force-emit ("œ~"), EOT inside and at the end, sentence punctuation
EDGE = [
    "", "x -", "3.", "a → b", "œ~", "Mann.", "z.B. bzw. Abk.",
    "Er sagte: „gut“ … und\tging.\x04Neu-\x04",
    "  -x --y 3,50 14:30 5.9.2018.", "ab~c þ ¤ 中文 😀!", "Ende.\x04\n",
    "\x04\x04", "a" * 280 + ".",
]


@pytest.fixture(scope="module", params=["matok", "datok"])
def tok(request):
    if request.param == "matok":
        return synth_tokenizer(N_ABBREV, SEED)
    return synth_datok(N_ABBREV, SEED)


@pytest.fixture(scope="module")
def wave(tok):
    rng = np.random.default_rng(SEED)
    texts = synth_text(tok, 51, [int(x) for x in rng.integers(0, 300, 51)],
                       seed=SEED) + EDGE
    meta, lengths, _ = SymbolEncoder(tok).encode_batch(texts)
    return meta, lengths


def _jax(tok, meta, lengths, entries, stops, max_steps):
    rep = make_rep(jax_twin(tok))
    ys, bad, steps, state = _run_machine(
        tuple(jnp.asarray(t) for t in rep.tables), jnp.asarray(meta),
        jnp.asarray(lengths), jnp.asarray(entries), jnp.asarray(stops),
        eps=rep.eps, unknown=rep.unknown, identity=rep.identity, rep=rep,
        max_steps=max_steps,
    )
    n = int(steps)
    ev = decode_events_batch(np.asarray(ys), n, as_arrays=True)
    return ev, np.asarray(bad), n, np.asarray(state)


def _torch(tok, meta, lengths, entries, stops, max_steps):
    ev, counts, bad, state, steps, _cold = run_machine(
        tables_from_tokenizer(tok, "cpu"), torch.from_numpy(meta),
        torch.from_numpy(lengths), torch.from_numpy(entries),
        torch.from_numpy(stops), max_steps, form="general",
    )
    counts = counts.numpy()
    assert (ev.numpy()[np.arange(ev.shape[1])[None, :] >= counts[:, None]] == 0).all()
    return (decode_events_compact(ev.numpy(), counts, as_arrays=True),
            bad.numpy(), steps.numpy(), state.numpy())


def _entries_and_stops(tok, meta, lengths, case):
    B = len(lengths)
    rng = np.random.default_rng(SEED + 1)
    if case == "root":
        return np.ones(B, np.int32), np.zeros(B, bool)
    # non-root entries: exit contexts of a first JAX run, shuffled
    _, _, _, state = _jax(tok, meta, lengths, np.ones(B, np.int32),
                          np.zeros(B, bool), 2 * meta.shape[1] + 64)
    return state[:, 0][rng.permutation(B)].astype(np.int32), rng.random(B) < 0.3


@pytest.mark.parametrize("case", ["root", "entries_stops"])
@pytest.mark.parametrize("budget", ["full", "tiny"])
def test_plain_machine_matches_jax(tok, wave, case, budget):
    meta, lengths = wave
    entries, stops = _entries_and_stops(tok, meta, lengths, case)
    max_steps = 2 * meta.shape[1] + 64 if budget == "full" else 40
    ev_j, bad_j, n_j, state_j = _jax(tok, meta, lengths, entries, stops, max_steps)
    ev_t, bad_t, steps_t, state_t = _torch(tok, meta, lengths, entries, stops,
                                           max_steps)
    assert (budget == "tiny") == bool(bad_j.any())
    np.testing.assert_array_equal(bad_t, bad_j)
    np.testing.assert_array_equal(state_t, state_j)
    assert int(steps_t.max()) == n_j
    for i, (a, b) in enumerate(zip(ev_t, ev_j)):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {i}")


def test_synth_model_is_seeded_and_reaches_backtrack_and_force(wave):
    """The fixture is a pure function of its seed, and its texts take
    the ε backtrack (f2) and force-emit (f3) paths."""
    a, b = synth_tokenizer(N_ABBREV, SEED), synth_tokenizer(N_ABBREV, SEED)
    assert a.array.tobytes() == b.array.tobytes() and a.abbrevs == b.abbrevs
    assert synth_tokenizer(N_ABBREV, SEED + 1).array.tobytes() != a.array.tobytes()
    assert a.state_count > 1000 and len(a.array) == 171 * (a.state_count + 1)
    meta, lengths = wave
    B = len(lengths)
    *_, state = _jax(a, meta, lengths, np.ones(B, np.int32), np.zeros(B, bool),
                     2 * meta.shape[1] + 64)
    assert state[:, 4].sum() > 0 and state[:, 5].sum() > 0
