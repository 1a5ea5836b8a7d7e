"""Probe: the hot-entry fetch on the card, KF against its plain version.

Counterpart of ``bench_micro/micro_pallas.py``: the same ``MB_*`` knobs
and defaults (``MB_B`` 16384, ``MB_H`` 384, ``MB_BL`` 1024, kept for
the record, ``MB_STEPS`` 64), the same exactness check first, then the
same chained loop timed for both versions.  The TPU ran the loop as one
compiled ``fori_loop`` calling ``pallas_call`` per step; here the loop
of ``MB_STEPS`` fetches (one KF launch each, or the plain version's
torch ops) is captured in one CUDA graph and its replays are timed
(``us_per_step``, ``ns_per_lane_step``, ``ms_per_call``), beside the
same loop launched step by step from Python (``eager_*``); KF's row
also counts the KF launches its replays ran (``graph_launches``: the
replays times the graph's KF nodes).  KF is prepared once
(``HotFetch``), as ``make_pallas_fetch`` prepares its planes once.

    python -m datok_tpu_torch.bench_micro.micro_pallas

Prints one JSON line per result, each with the card's name and power
limit, and returns the timings; needs a GPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..kernels.hot_fetch import KERNEL_NAME, HotFetch, hot_fetch_plain
from .planes import (N_SYMBOLS, card, chain_times, fetch_inputs,
                     fetch_planes_from_numpy, require_cuda)

REPS = 5


def config():
    env = os.environ.get
    return {"B": int(env("MB_B", "16384")), "H": int(env("MB_H", "384")),
            "BL": int(env("MB_BL", "1024")), "STEPS": int(env("MB_STEPS", "64"))}


def chain(fetch, a0: torch.Tensor, h0: torch.Tensor, steps: int, H: int):
    """The probe's loop (micro_pallas.py:95-100): XOR of the entries of
    ``steps`` chained fetches, ``h' = (entry >> 5) & (H - 1)`` (a mask,
    not a modulo, where H is no power of two) and ``a' = (a + 1) & 255``."""
    a, h, acc = a0, h0, torch.zeros_like(a0)
    for _ in range(steps):
        entry = fetch(a, h)
        a, h, acc = (a + 1) & (N_SYMBOLS - 1), (entry >> 5) & (H - 1), acc ^ entry
    return acc


def timed_loop(fetch, tag, a0, h0, cfg, card_line, kernel=""):
    """The chain eager and as graph replays (equal outputs); prints and
    returns its timings (with the launches of ``kernel`` that the
    replays ran), with the chain's output."""
    steps = cfg["STEPS"]
    eager, graph, out, replayed = chain_times(
        lambda: chain(fetch, a0, h0, steps, cfg["H"]), REPS, kernel)
    res = {"variant": tag, "B": cfg["B"], "H": cfg["H"], "BL": cfg["BL"],
           "ns_per_lane_step": graph * 1e6 / (cfg["B"] * steps),
           "us_per_step": graph * 1e3 / steps, "ms_per_call": graph,
           "eager_us_per_step": eager * 1e3 / steps, "eager_ms_per_call": eager,
           "graph_launches": replayed, "card": card_line}
    print(json.dumps(res), flush=True)
    return res, out


def main():
    dev = require_cuda()
    cfg = config()
    card_line = card()
    B, H = cfg["B"], cfg["H"]
    planes_np, a_np, h_np = fetch_inputs(B, H)
    planes = fetch_planes_from_numpy(planes_np, dev)

    def plain(a, h):
        return hot_fetch_plain(a, h, planes)

    kernel = HotFetch(planes, 3, True)

    a = torch.from_numpy(a_np).to(dev)
    h = torch.from_numpy(h_np).to(dev)
    ex, got = plain(a, h), kernel(a, h)
    n_bad = int((ex != got).sum())
    assert n_bad == 0, f"mismatch: {n_bad} lanes differ"
    print(json.dumps({"exactness": "ok"}), flush=True)

    rng = np.random.default_rng(1)
    a0 = torch.from_numpy(rng.integers(1, 200, B).astype(np.int32)).to(dev)
    h0 = torch.from_numpy(rng.integers(0, H, B).astype(np.int32)).to(dev)
    r1, o1 = timed_loop(plain, "torch_3p", a0, h0, cfg, card_line)
    r2, o2 = timed_loop(kernel, "cuda_3p", a0, h0, cfg, card_line,
                        KERNEL_NAME)
    assert torch.equal(o1, o2), "loop outputs differ"
    return [r1, r2]


if __name__ == "__main__":
    main()
