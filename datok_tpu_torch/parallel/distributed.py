"""Corpus runs over several processes (``torch.distributed`` over gloo).

Counterpart of datok_tpu/parallel/distributed.py:

* every process runs the same program (``initialize``, from the
  variables a launcher such as ``torchrun`` sets);
* the corpus file list is split **deterministically by rank**
  (:func:`process_shard`): processes never exchange input bytes, only
  counters, a few dozen scalars a run;
* within a process the lanes are data-parallel over its devices
  (:class:`~datok_tpu_torch.parallel.mesh.ShardedEngine`), the table
  replicated on each;
* the corpus counters are the only collective: one int64 all-reduce
  over gloo on CPU tensors at the end of a run.  Gloo, not NCCL: the
  tensors are tiny and live on the host, and NCCL cannot put two ranks
  on one card.

Everything here degrades to process 0 of 1 in a single process.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.corpus import CorpusRunner
from ..runtime.writer import SIMPLE


def get_rank() -> int:
    """This process's rank (0 unless ``torch.distributed`` is
    initialized)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """The number of processes (1 unless ``torch.distributed`` is
    initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(
    master_addr: Optional[str] = None,
    master_port: Optional[int] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join the process group of a multi-process run (idempotent).

    Arguments default to the variables ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  Returns True if several processes run
    after the call.  Without ``WORLD_SIZE`` (or with 1) the call is a
    silent no-op, and the rest of this module behaves as process 0 of
    1."""
    if dist.is_initialized():
        return get_world_size() > 1
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if world_size <= 1:
        return False
    rank = int(env["RANK"]) if rank is None else rank
    master_addr = master_addr or env.get("MASTER_ADDR", "localhost")
    master_port = int(env["MASTER_PORT"]) if master_port is None \
        else master_port
    dist.init_process_group(
        "gloo", init_method=f"tcp://{master_addr}:{master_port}",
        world_size=world_size, rank=rank)
    return True


def process_shard(
    items: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """This process's deterministic shard of a corpus item list.

    Contiguous block assignment (not round-robin): corpus files are
    commonly sorted so that neighbours have similar sizes, and blocks
    keep each host's working set contiguous on shared filesystems.
    Every item is assigned to exactly one process; the union over all
    processes is the full list.
    """
    pi = get_rank() if process_index is None else process_index
    pc = get_world_size() if process_count is None else process_count
    n = len(items)
    lo = (n * pi) // pc
    hi = (n * (pi + 1)) // pc
    return list(items[lo:hi])


def local_devices() -> List[torch.device]:
    """The cards this process shards over: every card, or, where
    ``LOCAL_RANK`` is set (several ranks on one host), the card
    ``LOCAL_RANK % device_count``.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card to "
                           "shard over")
    n = torch.cuda.device_count()
    if "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]) % n)]
    return [torch.device("cuda", i) for i in range(n)]


def rank_device() -> torch.device:
    """The card a corpus run of this process takes when the caller names
    none: ``cuda:{LOCAL_RANK % count}`` where a launcher set
    ``LOCAL_RANK``, else ``cuda:{rank % count}``.  One card a process is
    how a run over several cards scales (one wave over several cards
    does not yet).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card for "
                           "this process")
    local = int(os.environ.get("LOCAL_RANK", get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """A (processes, local devices) grid: row r holds the devices rank
    r shards over (``devices`` for this process, :func:`local_devices`
    by default), gathered from every rank.  Every rank must shard over
    as many devices.  In a single process the grid has one row."""
    local = [torch.device(d) for d in
             (local_devices() if devices is None else devices)]
    if get_world_size() <= 1:
        return [local]
    rows: list = [None] * get_world_size()
    dist.all_gather_object(rows, [str(d) for d in local])
    if len({len(r) for r in rows}) != 1:
        raise ValueError(f"ranks shard over unequal device counts: {rows}")
    return [[torch.device(d) for d in r] for r in rows]


def allreduce_counters(counters: dict) -> dict:
    """Sum integer counters across all processes (identity if single).

    Every process passes the same keys (the keys are sorted before the
    sum).  This is the one collective of a corpus run."""
    if get_world_size() <= 1:
        return dict(counters)
    keys = sorted(counters)
    t = torch.tensor([int(counters[k]) for k in keys], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, t.tolist())}


def run_corpus_distributed(
    tok,
    files: Sequence[str],
    out_dir: str,
    flags: Optional[int] = None,
    engine=None,
    verbose: bool = False,
    device=None,
) -> dict:
    """Tokenize a corpus across all processes; return global counters.

    Each process handles its :func:`process_shard` of ``files`` with
    the resumable :class:`~datok_tpu_torch.runtime.corpus.CorpusRunner`
    (its own manifest, ``manifest.p{rank}.json``, so any process can
    crash and resume on its own), on ``engine`` or a new engine on
    ``device`` (this process's :func:`rank_device` by default); then the
    counters are summed over the processes, and ``processes`` gives
    their number.
    """
    if engine is None and device is None:
        device = rank_device()
    runner = CorpusRunner(
        tok,
        out_dir,
        flags=SIMPLE if flags is None else flags,
        engine=engine,
        manifest_name=f"manifest.p{get_rank()}.json",
        device=device,
    )
    stats = runner.run(process_shard(files), verbose=verbose)
    local = {
        k: int(v)
        for k, v in stats.items()
        if isinstance(v, (int, np.integer))
    }
    out = allreduce_counters(local)
    out["processes"] = get_world_size()
    return out
