"""Lane-sharded batch tokenization over several devices.

Counterpart of datok_tpu/parallel/mesh.py.  The corpus lanes are
data-parallel across devices; the transition table is replicated (12.6
MB for the DE matrix); the shards exchange nothing until their corpus
counters are summed, which is what ``psum`` does in the JAX module.
Each shard is one K1 launch in the engine's form
(:func:`~datok_tpu_torch.kernels.transduce.transduce`, or
:func:`~datok_tpu_torch.kernels.transduce.transduce_general` with
``engine="general"``, which :class:`BatchEngine` takes) over a
contiguous block of lanes, on a CUDA stream of its own, so the shards
run at once, also when several of them share one card; on the CPU each
shard is one run of the plain machine.

What the JAX module has and this one does not, and why:

* ``mesh`` (a ``jax.sharding.Mesh``): the shards are a plain list of
  torch devices, ``devices``, one a shard;
* ``kernel_bl``: K1 has no lane block (it runs one lane a thread), so
  the lane quantum is the shard count alone;
* ``per_wave``: forced off, as in the JAX module (its sharded call
  closes over replicated tables): the shards run the engine's own hot
  set, replicated to each device, and a wave's set is refused.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels.transduce import outputs
from ..runtime.engine import BatchEngine
from ..runtime.events import EV_SENT, EV_TEXT, EV_TOKEN
from ..runtime.rep import tables_from_tokenizer, with_hot


def _counters(ev, counts, lengths, state) -> torch.Tensor:
    """A shard's corpus counters (tokens, sentences, texts, chars,
    backtracks, force emits; datok_tpu/parallel/mesh.py:40-53) as a (6,)
    int64 tensor on its device.  Only ``ev[i, :counts[i]]`` holds lane
    i's events (K1 leaves the other columns unwritten), so the kinds are
    read from the first ``max(counts)`` columns and masked by the
    counts."""
    ev = ev[:, :max(1, int(counts.max()))] if counts.numel() else ev[:, :1]
    unwritten = (torch.arange(ev.shape[1], device=ev.device)[None, :]
                 >= counts[:, None])
    kinds = (ev & 3).masked_fill_(unwritten, 0)
    return torch.stack([
        (kinds == EV_TOKEN).sum(), (kinds == EV_SENT).sum(),
        (kinds == EV_TEXT).sum(), lengths.sum(dtype=torch.int64),
        state[:, 4].sum(dtype=torch.int64), state[:, 5].sum(dtype=torch.int64),
    ])


def balance_perm(lengths: Sequence[int], n_shards: int) -> np.ndarray:
    """Length-balancing lane permutation for an ``n_shards`` mesh.

    Lanes are sharded in contiguous blocks along axis 0, so a wave
    whose long documents cluster gives one shard most of the work and
    the others idle at the barrier (per-shard step counts are the
    efficiency number — see ``corpus_stats``).  Snake-deal documents
    by descending length across shards: shard s receives ranks
    s, 2n−1−s, 2n+s, … — cumulative work per shard stays within one
    document of even.  Returns ``perm`` such that submitting
    ``docs[perm[j]]`` as lane j balances the shards; invert with
    ``inv[perm] = arange`` to restore input order on the results.
    """
    order = np.argsort(
        -np.asarray(lengths, dtype=np.int64), kind="stable"
    )
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for i, idx in enumerate(order):
        s = i % n_shards
        if (i // n_shards) % 2:
            s = n_shards - 1 - s
        shards[s].append(int(idx))
    return np.asarray(
        [i for sh in shards for i in sh], dtype=np.int64
    )


@contextlib.contextmanager
def _on(d: torch.device, st):
    """``d`` as the current device and ``st`` as its current stream
    (nothing on the CPU, where ``st`` is None)."""
    if st is None:
        yield
        return
    with torch.cuda.device(d), torch.cuda.stream(st):
        yield


def _device(d) -> torch.device:
    """``d`` as a torch device; ``"cuda"`` names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class ShardedEngine(BatchEngine):
    """Data-parallel tokenization over several devices.

    Drop-in equivalent of :class:`BatchEngine` (it goes wherever one is
    taken as ``engine=``) that splits the lanes of every launch into
    ``len(devices)`` contiguous blocks, one a shard.  ``devices`` is a
    list of torch devices, one a shard, all CUDA or all CPU; a device
    may appear more than once, so that one card runs the sharded launch
    path.  The default is every card ``torch.cuda.device_count()``
    reports, and without a card the engine raises.  The keyword
    arguments are :class:`BatchEngine`'s; the hot set is chosen once and
    replicated with the table to each distinct device.

    After each launch, :attr:`last_counters` gives the corpus counters
    summed over the shards, :attr:`last_shard_steps` each shard's most
    steps of one lane, and :attr:`last_padded_lanes` the padding lanes
    (empty texts from the root) that made the lane count a multiple of
    the shard count.  The first two are computed when they are read,
    from the last launch's outputs, which the engine holds until its
    next launch: only :meth:`corpus_stats` reads them, and on the card
    counting every launch's events took longer than K1.

    On a card each shard's stream waits for the caller's current stream
    (where :meth:`run_raw_async` copies the inputs) before it reads
    them, and the caller's stream waits for every shard before the
    launch returns.  Shards on the engine's first device write row
    blocks of one set of outputs; a shard on another card writes its
    own, and its first ``max(counts)`` event columns and its lane rows
    are copied into those, so a launch returns tensors on the first
    device.  That copy has to read the shard's counts, so the host waits
    for each such shard's K1 before the launch returns.

    One wave does not get faster over several cards yet: K1's time is
    set by the longest lane, not the lane count, and the inputs reach
    the other cards one after another through the first.  On an NVIDIA
    H100 a wave over four cards took longer than on one.  To use
    several cards, run one process a card
    (:func:`~datok_tpu_torch.parallel.distributed.run_corpus_distributed`).
    """

    def __init__(self, tok, devices: Optional[Sequence] = None, **kwargs):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ShardedEngine() shards over every card, but "
                    "torch.cuda.is_available() is False; pass devices= "
                    "(for example ['cpu'] * n) to run on the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("devices is empty")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"devices mix types: {devs}")
        super().__init__(tok, devs[0], **kwargs)
        self.per_wave = False  # jax mesh.py:98-101
        self.devices = devs
        self.n_shards = len(devs)
        states = () if self.tables.hot is None else self.tables.hot.states
        self._tables = {self.device: self.tables}
        self._cold = {self.device: self._cold_total}
        for d in devs:
            if d not in self._tables:
                self._tables[d] = with_hot(tables_from_tokenizer(self.tok, d),
                                           states)
                self._cold[d] = torch.zeros(2, dtype=torch.int64, device=d)
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in devs]
        # per shard of the last launch, on the shard's device: its
        # (events, counts, lengths, state, steps, cold)
        self._parts: list = []
        self.last_padded_lanes = 0

    # -- the sharded launch -------------------------------------------

    def _run(self, meta, lengths, entries, stops, max_steps: int, spec=None):
        if spec is not None and spec is not self.tables.hot:
            raise NotImplementedError(
                "per-wave hot sets are single-device machinery; the "
                "sharded engine runs its own set (per_wave is forced off)")
        dev, n = self.device, self.n_shards
        B0, L = meta.shape
        pad = (-B0) % n
        if pad:  # padding lanes: empty texts from the root
            meta = torch.cat([meta, meta.new_zeros((pad, L))])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
            entries = torch.cat([entries, entries.new_ones(pad)])
            stops = torch.cat([stops, stops.new_zeros(pad)])
        B = B0 + pad
        per = B // n
        ev, counts, bad, state, steps, _ = outputs(B, max_steps, dev)
        cold = torch.empty((n, 2), dtype=torch.int64, device=dev)
        cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        kernel = self._kernel()
        parts, remote = [], []
        for s, (d, st) in enumerate(zip(self.devices, self._streams)):
            lo, hi = s * per, (s + 1) * per
            ins = (meta[lo:hi], lengths[lo:hi], entries[lo:hi], stops[lo:hi])
            out = None
            if d == dev:
                out = (ev[lo:hi], counts[lo:hi], bad[lo:hi], state[lo:hi],
                       steps[lo:hi], cold[s])
            if st is not None:
                st.wait_stream(cur)  # the inputs were copied on cur
            with _on(d, st):
                if d != dev:
                    ins = tuple(x.to(d, non_blocking=True) for x in ins)
                elif st is not None:
                    # memory of the caller's stream, used on the shard's
                    for x in ins + out:
                        x.record_stream(st)
                res = kernel(self._tables[d], *ins, max_steps,
                             cold_total=self._cold[d], out=out)
            parts.append((res[0], res[1], ins[1], res[3], res[4], res[5]))
            if d != dev:
                remote.append((lo, hi, d, st, res))
        for lo, hi, d, st, res in remote:
            with _on(d, st):
                E = max(1, int(res[1].max()))  # waits for this shard's K1
                ev[lo:hi, :E].copy_(res[0][:, :E], non_blocking=True)
                for dst, src in zip((counts, bad, state, steps), res[1:5]):
                    dst[lo:hi].copy_(src, non_blocking=True)
        if cur is not None:
            for st in self._streams:
                cur.wait_stream(st)
        self._parts = parts
        self.last_padded_lanes = pad
        return ev[:B0], counts[:B0], bad[:B0], state[:B0], steps[:B0]

    # -- what the last launch counted -----------------------------------

    def _last(self) -> list:
        """The last launch's per-shard outputs, once its shards are done."""
        for st in self._streams:
            if st is not None:
                st.synchronize()
        return self._parts

    @property
    def last_counters(self) -> Optional[np.ndarray]:
        """(tokens, sentences, texts, chars, backtracks, force emits) of
        the last launch, padding lanes included, summed over the shards
        (int64); None before the first launch."""
        parts = self._last()
        if not parts:
            return None
        return np.sum([_counters(ev, c, lens, state).cpu().numpy()
                       for ev, c, lens, state, _, _ in parts], axis=0)

    @property
    def last_shard_steps(self) -> np.ndarray:
        """Each shard's most steps of one lane in the last launch (int32;
        zeros before the first)."""
        parts = self._last()
        if not parts:
            return np.zeros(self.n_shards, np.int32)
        return np.asarray([int(p[4].max()) if p[4].numel() else 0
                           for p in parts], np.int32)

    @property
    def last_cold_share(self) -> Optional[float]:
        parts = self._last()
        if not parts:
            return None
        return self._share(sum(p[5].cpu() for p in parts))

    @property
    def cold_share(self) -> float:
        self._last()
        return self._share(sum(c.cpu() for c in self._cold.values()))

    def reset_cold(self) -> None:
        for c in self._cold.values():
            c.zero_()

    # -- host-facing surfaces (run_raw / tokenize_batch inherited;
    #    events_batch and corpus_stats balance lanes first) -----------

    def events_batch(
        self,
        texts: Sequence[str],
        entries=None,
        return_exits: bool = False,
        as_arrays: bool = False,
        stops=None,
    ):
        """Shard-balanced :meth:`BatchEngine.events_batch`.

        Lanes shard in contiguous blocks, so a direct batch whose long
        texts cluster would idle every other shard at the barrier.
        Balance-permute the lanes, run, unpermute the results — output
        order and exactness unchanged.
        """
        n = len(texts)
        if self.n_shards > 1 and n > self.n_shards:
            perm = balance_perm([len(t) for t in texts], self.n_shards)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n)
            # Python ints index lists several times faster than numpy's
            p, q = perm.tolist(), inv.tolist()
            r = super().events_batch(
                [texts[i] for i in p],
                None if entries is None else np.asarray(entries)[perm],
                return_exits,
                as_arrays,
                None if stops is None else np.asarray(stops)[perm],
            )
            if return_exits:
                out, exits = r
                return [out[i] for i in q], exits[inv]
            return [r[i] for i in q]
        return super().events_batch(
            texts, entries, return_exits, as_arrays, stops
        )

    def corpus_stats(self, texts: Sequence[str],
                     balance: bool = True) -> dict:
        """Tokenize a corpus and return its counters summed over the
        shards (the keys of datok_tpu/parallel/mesh.py:313-355).

        ``balance=False`` keeps the caller's lane order; the default
        balances like :meth:`events_batch`."""
        if balance and self.n_shards > 1 and len(texts) > self.n_shards:
            # counters are order-independent; balancing the lanes is
            # pure efficiency (see events_batch)
            perm = balance_perm([len(t) for t in texts], self.n_shards)
            texts = [texts[i] for i in perm.tolist()]
        meta, lengths, _ = self.encoder.encode_batch(texts)
        _ev, _counts, bad, _state, _steps = self.run_raw_device(meta, lengths)
        stats = self.last_counters
        # Padding lanes are empty texts and emit one sentence-end and
        # one text-end each; discount them from the summed counters.
        pad = self.last_padded_lanes
        shard_steps = self.last_shard_steps.astype(np.int64)
        smax = int(shard_steps.max()) if shard_steps.size else 0
        return {
            "tokens": int(stats[0]),
            "sentences": int(stats[1]) - pad,
            "texts": int(stats[2]) - pad,
            "chars": int(stats[3]),
            "backtracks": int(stats[4]),
            "force_emits": int(stats[5]),
            "fallback_lanes": int(bad.sum()),
            "shards": self.n_shards,
            # shards never communicate until the counters are summed, so
            # efficiency over several cards is work balance x (1 -
            # padded waste); both are reported per run
            "shard_steps": shard_steps.tolist(),
            "balance_efficiency": (
                round(float(shard_steps.mean()) / smax, 4) if smax else 1.0
            ),
            "padded_lanes": int(pad),
            "padded_fraction": round(pad / max(1, len(texts) + pad), 4),
        }
