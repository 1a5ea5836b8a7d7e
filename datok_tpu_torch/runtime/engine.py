"""Host-facing batched tokenization engine on a torch device.

Counterpart of ``BatchEngine`` (datok_tpu/runtime/jax_engine.py:1600-
2251, the parts on the main path).  A wave of texts runs in this order:
native wave encode (``SymbolEncoder.encode_batch``, with the skip class
of the model's run skip), the device machine
(:func:`datok_tpu_torch.kernels.transduce.transduce`: K1 on a CUDA
device, the plain machine on the CPU, both with the full step; with
``engine="general"`` :func:`~datok_tpu_torch.kernels.transduce.transduce_general`,
the general step over the model's own layout) on the encoder's (B, L)
meta as it is, the copy of the compact event rows to the host, host
decode, and exact host repair of lanes that ran out of their step
budget.
Formatting goes through ``TokenWriter`` (or its native twin).  Asked
for one, the engine chooses K1's hot set once, as the JAX engine does
(:mod:`datok_tpu_torch.runtime.hot`), and with ``per_wave=True`` (the
default, as in the JAX engine) gives each wave a set of its own, built
from a census of its documents (:meth:`BatchEngine.wave_spec`); it
counts the steps K1 spent on cold states
(:attr:`BatchEngine.last_cold_share`, :attr:`BatchEngine.cold_share`).
"""

from __future__ import annotations

import warnings
from dataclasses import replace
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..kernels.transduce import transduce, transduce_general
from ..utils.native import native_state_census
from .decode import decode_events_compact
from .encode import SymbolEncoder, text_to_codepoints
from .hot import (census_cut, default_profile_texts, hot_capacity,
                  profile_hot_states, sample_texts, wave_hot_states)
from .events import format_events
from .machine import MAX_SEGMENT
from .rep import HotTable, hot_table, tables_from_tokenizer, with_hot
from .repair import transduce_doc_exact
from .writer import SIMPLE


# the JAX engine's values (jax_engine.py:1603-1607)
ENGINES = ("auto", "pallas", "general", "hot")

# wave sets a cache holds before it starts anew (jax_engine.py:1857)
WAVE_CACHE = 16

# the lane vectors' dtypes, for defaults made on the device
_TORCH_DTYPE = {np.int32: torch.int32, np.bool_: torch.bool}


class BatchEngine:
    """Batched tokenization of many texts as parallel lanes.

    ``device`` is a torch device: ``"cuda"`` (the default) runs K1 and
    raises when no card is present; ``"cpu"`` runs the plain machine.
    ``steps_factor`` sets each lane's step budget (:meth:`max_steps_for`).

    ``engine`` picks the device machine, with the JAX engine's values:

    - ``"auto"`` (the default): a ``.datok`` model is converted to the
      dense matrix layout and the machine runs K1's full step (the TPU
      kernel's); when the conversion fails, the engine warns and runs
      the general step over the double array, on the card;
    - ``"pallas"``: the full step, which needs the matrix; a failed
      conversion raises;
    - ``"general"``: the general step (one character or backtrack a
      step; the JAX general machine) over the model's own layout: base
      and check for a ``.datok`` model, the table for a ``.matok`` one.
      A double array keeps the model's sub-second load and its smaller
      tables where the dense table would not fit;
    - ``"hot"``: the JAX hot machine's counterpart (``_run_machine_hot``,
      its hot steps with the run skip, over a profiled hot set; the JAX
      engine's own choice on every backend but a TPU): K1's full step
      with the profiled set that ``"auto"`` gives, or ``hot_size``
      states where it names a positive number.  K1 has no form with the
      run skip but without fused boundaries; a fused boundary changes
      only the step counts, which are the budget's, not the results.
      A ``.datok`` model is converted, and a failed conversion raises.

    :attr:`engine` holds the machine that runs: ``"pallas"``, ``"hot"``
    or ``"general"``.

    ``hot_size`` is the size of K1's hot set, the states whose rows K1
    keeps in shared memory: 0 (the default) keeps none and K1 reads
    every cell from the whole table;
    ``"auto"`` takes the JAX engine's auto size (:func:`profile_hot_states`
    over :func:`default_profile_texts`) capped at what one block's shared
    memory holds (:func:`hot_capacity`, 339 states at 171 symbols); an
    int takes that many.  On an H100 the hot set made K1 slower on every
    wave of mixed text (PERF.md), hence the default.  A model whose cells
    cannot carry the tags (2^20 states or more) gets none, and so does a
    double array.  The hot set changes where K1 reads cells, never its
    results.

    ``per_wave`` (the JAX engine's default, True) gives each wave a hot
    set of its own (:meth:`wave_spec`), where the engine has a hot set
    on a matrix model and ``engine`` is ``"auto"`` or ``"pallas"`` (the
    JAX gate: its fused kernel).  With the default ``hot_size=0`` it
    does nothing, and the engine runs exactly as without it.  The
    port's encoder stamps only the skip class into meta, which does not
    depend on the hot set (the JAX encoder also stamps the spec's symbol
    classes, ``encoder_for(spec)``), so a wave is encoded once, by
    :attr:`encoder`, whatever its set.
    """

    # The sizes of a wave's own set (jax_engine.py:1799, where they are
    # 384 and 512): each wave takes the smallest rung below the engine's
    # own set's size that holds the states covering 99.9% of its
    # sampled fetches.  A rung's rows take 4 x 171 bytes a state of the
    # SM's 256 KB of shared memory and L1 at the DE model's width:
    # 87.6 KB at 128 states, 175 KB at 256, against 232 KB at the
    # capacity of 339 (hot_capacity), so a smaller rung leaves L1 the
    # room that holds the lanes' meta and the per-state words, and
    # stages fewer bytes into every block.  No rung lies above what
    # one block's shared memory holds: a rung at or above the engine's
    # size is never taken.
    WAVE_H_LADDER = (128, 256)

    def __init__(self, tok, device="cuda", steps_factor: float = 2.0,
                 hot_size: Union[int, str] = 0, engine: str = "auto",
                 per_wave: bool = True):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device 'cuda' requested but torch.cuda.is_available() "
                    "is False"
                )
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        if tok.type() == "DATOK" and engine != "general":
            # the conversion is runtime-equivalent (jax_engine.py:1644-1665)
            try:
                tok = tok.to_matrix()
            except Exception as e:
                # an explicitly requested full step must not silently
                # downgrade to the general one
                if engine in ("pallas", "hot"):
                    raise RuntimeError(
                        f"engine={engine!r} requires the dense matrix "
                        f"layout but to_matrix() failed: {e}"
                    ) from e
                warnings.warn(
                    f"double-array → matrix conversion failed ({e}); "
                    "falling back to the serial-gather engine",
                    RuntimeWarning,
                    stacklevel=2,
                )
        if tok.type() != "MATOK" or engine == "general":
            self.engine = "general"
        else:
            self.engine = "hot" if engine == "hot" else "pallas"
        self.tok = tok
        self.device = device
        self.steps_factor = steps_factor
        tables = tables_from_tokenizer(tok, device)
        states: Sequence[int] = ()
        if tok.type() == "MATOK":
            cap = hot_capacity(tables.max_sym)
            if hot_size != "auto" and not 0 <= int(hot_size) <= cap:
                raise ValueError(f"hot_size {hot_size} is outside 0..{cap}, "
                                 "what one block's shared memory holds")
            limit = hot_size if hot_size == "auto" else int(hot_size)
            if self.engine == "hot" and not limit:
                limit = "auto"
            if limit:
                states = profile_hot_states(
                    tok, default_profile_texts(tok), limit)[:cap]
        self.tables = with_hot(tables, states)
        self.hot_size = self.tables.hot.H if self.tables.hot else 0
        self.per_wave = bool(per_wave and self.tables.hot is not None
                             and self.engine == "pallas")
        # wave sets by (size, census states), as _wave_spec_cache
        self._wave_cache: dict = {}
        # meta's run lengths must count the skip class the per-state
        # words were built with (jax_engine.py:1741-1748): with another
        # class a skip would be wrong, not merely slower; the general
        # step reads no run lengths (jax_engine.py:1749)
        self.encoder = (SymbolEncoder(tok) if self.engine == "general"
                        else SymbolEncoder(tok, lc_mask=self.tables.lc_mask))
        # (steps whose state was cold, all steps): of the last launch,
        # and summed over launches since reset_cold()
        self._last_cold: Optional[torch.Tensor] = None
        self._cold_total = torch.zeros(2, dtype=torch.int64, device=device)

    def reset_cold(self) -> None:
        """Start :attr:`cold_share` anew (after the launches before it
        have finished)."""
        self._cold_total.zero_()

    @staticmethod
    def _share(cold) -> float:
        n_cold, n_steps = (int(x) for x in cold.tolist())
        return n_cold / n_steps if n_steps else 0.0

    @property
    def last_cold_share(self) -> Optional[float]:
        """The share of the last launch's steps whose state was cold
        (outside the hot set); None before the first launch.  Reading it
        waits for that launch."""
        return None if self._last_cold is None else self._share(self._last_cold)

    @property
    def cold_share(self) -> float:
        """The same over every launch since :meth:`reset_cold` (read it
        after they have finished)."""
        return self._share(self._cold_total)

    def max_steps_for(self, L: int) -> int:
        return int(self.steps_factor * L) + 64

    # -- per-wave hot sets --------------------------------------------
    # A profiled set serves the texts it was profiled on; a wave's own
    # working set is small, so each wave may take a set built from a
    # census of its own documents (jax_engine.py:1762-1773).  K1 takes
    # any hot set at each launch: selecting one swaps the tagged table,
    # the rows and hot_of under the same kernel.

    def census_states(self, texts, sample_chars: int = 262144):
        """Fetch-frequency state census of a document sample (the exact
        native walk), or None when unavailable.  Samples are document
        prefixes round-robin across ≤256 docs, joined by newlines
        (:func:`~datok_tpu_torch.runtime.hot.sample_texts`)."""
        sample = sample_texts(texts, sample_chars)
        if sample is None:
            return None
        metas = self.encoder.encode(text_to_codepoints(sample))
        r = native_state_census(self.tok, np.asarray(metas, np.int32))
        return None if r is None else r[0]

    def wave_spec(self, texts, sample_chars: int = 262144
                  ) -> Optional[HotTable]:
        """The hot set of the wave ``texts``: the states of its census
        (:func:`~datok_tpu_torch.runtime.hot.census_cut`) at the smallest
        rung of :attr:`WAVE_H_LADDER` that holds them, filled from the
        engine's own set (:func:`~datok_tpu_torch.runtime.hot.wave_hot_states`),
        tagged on the device (:func:`~datok_tpu_torch.runtime.rep.hot_table`).
        Returns the engine's own set (``tables.hot``) when the engine has
        none or is not per-wave, the census is unavailable, or the set
        comes out the same.

        Sets are cached by (size, census states), so a repeated set is
        one object; the cache starts anew past :data:`WAVE_CACHE`
        entries, so it holds at most 17 tagged tables (17 x 12.59 MB at
        the DE model's size).  A set a launch still reads is held by its
        wave (and recorded on the launch's stream), never rewritten."""
        own = self.tables.hot
        if not self.per_wave:
            return own
        counts = self.census_states(texts, sample_chars)
        if counts is None:
            return own
        H, states = census_cut(counts, own.H, self.WAVE_H_LADDER)
        key = (H, states.tobytes())
        spec = self._wave_cache.get(key)
        if spec is None:
            hot = wave_hot_states(states, own.states[:H])
            if np.array_equal(hot, own.states):
                spec = own
            else:
                spec = hot_table(self.tables, hot)
            if len(self._wave_cache) > WAVE_CACHE:
                self._wave_cache.clear()
            self._wave_cache[key] = spec
        return spec

    def _launch(self, meta, lengths, entries, stops, spec=None):
        """The device machine on (B, L) ``meta`` and (B,) lane tensors,
        all on the engine's device, with the hot set ``spec`` (None: the
        engine's own)."""
        L = meta.shape[1]
        if L > MAX_SEGMENT:
            raise ValueError(
                f"segment length {L} exceeds packed-event limit "
                f"{MAX_SEGMENT}; use the segmentation pipeline for longer "
                "streams"
            )
        return self._run(meta, lengths, entries, stops, self.max_steps_for(L),
                         spec)

    def _kernel(self):
        """The wrapper of the engine's form of K1 (looked up at each
        launch, so that a caller may wrap the module's function)."""
        return transduce_general if self.engine == "general" else transduce

    def _tables_for(self, spec: Optional[HotTable]):
        """The tables of a launch with the hot set ``spec``.  On a card
        the launch's stream waits until the set is written, and the
        set's tensors are recorded on that stream, so that the caching
        allocator hands none of them out again before K1 has read it."""
        if spec is None or spec is self.tables.hot:
            return self.tables
        if self.tables.hot is None:
            raise ValueError("a hot set was given to an engine without one")
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if spec.ready is not None:
                cur.wait_event(spec.ready)
            for x in (spec.table, spec.rows, spec.hot_of):
                x.record_stream(cur)
        return replace(self.tables, hot=spec)

    def _run(self, meta, lengths, entries, stops, max_steps: int, spec=None):
        """One launch of the device machine over the wave."""
        *out, self._last_cold = self._kernel()(
            self._tables_for(spec), meta, lengths, entries, stops, max_steps,
            cold_total=self._cold_total)
        return tuple(out)

    def run_raw_device(self, meta, lengths, entries=None, stops=None,
                       spec: Optional[HotTable] = None):
        """Run the device machine on one wave; returns device tensors
        ``(events (B, max_steps), counts, bad, state (B, 6), steps)``
        (see :func:`datok_tpu_torch.runtime.machine.run_machine`).

        ``entries`` optionally sets per-lane packed entry contexts;
        ``stops`` marks lanes that cut at their end instead of running
        the EOF epilogue; ``spec`` is the wave's hot set
        (:meth:`wave_spec`; None: the engine's own).  Each of ``meta``
        and the lane vectors is a numpy array, copied to the engine's
        device, or a tensor already there (int32; ``stops`` bool),
        which the launch takes as it is, with no trip through the host
        (the JAX engine's device arrays, jax_engine.py:1889); a tensor
        on another device raises."""
        B = meta.shape[0]
        dev = self.tables.device

        def put(name, x, dtype, fill=0):
            if x is None:
                return torch.full((B,), fill, dtype=_TORCH_DTYPE[dtype],
                                  device=dev)
            if isinstance(x, torch.Tensor):
                if x.device != dev:
                    raise ValueError(f"{name} is on {x.device}, the engine "
                                     f"on {dev}")
                return x
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

        return self._launch(put("meta", meta, np.int32),
                            put("lengths", lengths, np.int32),
                            put("entries", entries, np.int32, 1),
                            put("stops", stops, np.bool_), spec)

    def run_raw_async(self, meta: torch.Tensor, lengths: torch.Tensor,
                      entries: torch.Tensor, stops: torch.Tensor,
                      spec: Optional[HotTable] = None):
        """:meth:`run_raw_device` on host tensors without blocking the
        host: ``meta`` (B, L) int32, ``lengths`` and ``entries`` (B,)
        int32, ``stops`` (B,) bool.

        On a CUDA device they must lie in pinned memory (a copy from
        pageable memory holds the calling thread until it is staged);
        each is copied with ``copy_(..., non_blocking=True)`` on the
        current stream, which K1 then runs on, and nothing synchronises.
        The caller keeps the host tensors unchanged until the stream has
        passed the launch (an event recorded after it), and holds
        ``spec`` (the wave's hot set) as long.  On the CPU the tensors
        are used as they are."""
        host = (("meta", meta), ("lengths", lengths), ("entries", entries),
                ("stops", stops))
        dev = self.device
        if dev.type == "cuda":
            for name, x in host:
                if not x.is_pinned():
                    raise ValueError(f"{name} is not in pinned host memory")
            meta, lengths, entries, stops = (
                torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(
                    x, non_blocking=True)
                for _, x in host
            )
        return self._launch(meta, lengths, entries, stops, spec)

    def run_raw(self, meta: np.ndarray, lengths: np.ndarray,
                entries: Optional[np.ndarray] = None,
                stops: Optional[np.ndarray] = None,
                spec: Optional[HotTable] = None):
        """Run the device machine; returns numpy
        ``(ev, counts, bad, steps, state)``.

        Unlike the JAX engine there is no step-indexed event buffer:
        lane i's packed events are ``ev[i, :counts[i]]`` in step order,
        and ``ev`` has ``max(counts)`` columns, the only rows that cross
        to the host.  ``steps`` (B,) counts each lane's steps; ``state``
        rows are ``(ctx, ckpt, b, c, n_backtrack, n_force)``."""
        ev, counts, bad, state, steps = self.run_raw_device(
            meta, lengths, entries, stops, spec
        )
        E = max(1, int(counts.max())) if counts.numel() else 1
        return (ev[:, :E].cpu().numpy(), counts.cpu().numpy(),
                bad.cpu().numpy(), steps.cpu().numpy(), state.cpu().numpy())

    def run_events_compact(self, meta, lengths,
                           entries: Optional[np.ndarray] = None,
                           stops: Optional[np.ndarray] = None,
                           spec: Optional[HotTable] = None):
        """Run the device machine and fetch compact events; returns
        ``(ev[B, E], counts[B], bad[B], state)`` numpy arrays, with
        ``E`` at least the fullest lane's count."""
        ev, counts, bad, _steps, state = self.run_raw(
            meta, lengths, entries, stops, spec
        )
        return ev, counts, bad, state

    def events_batch(self, texts: Sequence[str],
                     entries: Optional[np.ndarray] = None,
                     return_exits: bool = False, as_arrays: bool = False,
                     stops: Optional[np.ndarray] = None):
        """Boundary events per text (device path, exact host repair of
        lanes over budget).

        ``as_arrays=True`` yields per-text (N, 3) int32 arrays — the
        shape the native writer feeds.  ``stops[i]`` runs lane i as a
        cut (stop at its end, no EOF epilogue).  A per-wave engine runs
        the texts on their own hot set (:meth:`wave_spec`)."""
        if not texts:
            return ([], np.zeros(0, np.int32)) if return_exits else []
        spec = self.wave_spec(texts) if self.per_wave else None
        meta, lengths, _cps = self.encoder.encode_batch(texts)
        ev, counts, bad, state = self.run_events_compact(
            meta, lengths, entries, stops, spec
        )
        decoded = decode_events_compact(ev, counts, as_arrays=as_arrays)
        exits = state[:, 0].copy()
        out: List = []
        for i, text in enumerate(texts):
            if not bad[i]:
                out.append(decoded[i])
                continue
            e0 = int(entries[i]) if entries is not None else 1
            evs, exits[i] = transduce_doc_exact(
                self.tok, text, e0,
                bool(stops[i]) if stops is not None else False,
                encoder=self.encoder,
            )
            if as_arrays:
                evs = np.asarray(evs, dtype=np.int32).reshape(-1, 3)
            out.append(evs)
        if return_exits:
            return out, exits
        return out

    def tokenize_batch(self, texts: Sequence[str],
                       flags: Optional[int] = None) -> List[str]:
        fl = SIMPLE if flags is None else flags
        return [
            format_events(evs, text, fl)
            for text, evs in zip(texts, self.events_batch(texts))
        ]
