"""Probe: the hot-entry fetch on the card, KF against its plain version.

Counterpart of ``bench_micro/micro_pallas.py``: the same ``MB_*`` knobs
and defaults (``MB_B`` 16384, ``MB_H`` 384, ``MB_BL`` 1024, kept for
the record, ``MB_STEPS`` 64), the same exactness check first, then the
same chained loop timed for both versions.  The TPU ran the loop as one
compiled ``fori_loop`` calling ``pallas_call`` per step; here each step
is one KF launch (or the plain version's torch ops), so at B=16384 the
kernel's loop is bound by launch latency.

    python -m datok_tpu_torch.bench_micro.micro_pallas

Prints one JSON line per result, each with the card's name and power
limit; needs a GPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..kernels.hot_fetch import hot_fetch, hot_fetch_plain
from .planes import (N_SYMBOLS, card, cuda_ms, fetch_inputs,
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


def timed_loop(fetch, tag, a0, h0, cfg, card_line):
    ms, out = cuda_ms(lambda: chain(fetch, a0, h0, cfg["STEPS"], cfg["H"]), REPS)
    print(json.dumps({
        "variant": tag, "B": cfg["B"], "H": cfg["H"], "BL": cfg["BL"],
        "ns_per_lane_step": ms * 1e6 / (cfg["B"] * cfg["STEPS"]),
        "ms_per_call": ms, "card": card_line,
    }), flush=True)
    return out


def main():
    dev = require_cuda()
    cfg = config()
    card_line = card()
    B, H = cfg["B"], cfg["H"]
    planes_np, a_np, h_np = fetch_inputs(B, H)
    planes = fetch_planes_from_numpy(planes_np, dev)

    def plain(a, h):
        return hot_fetch_plain(a, h, planes)

    def kernel(a, h):
        return hot_fetch(a, h, planes)

    a = torch.from_numpy(a_np).to(dev)
    h = torch.from_numpy(h_np).to(dev)
    ex, got = plain(a, h), kernel(a, h)
    n_bad = int((ex != got).sum())
    assert n_bad == 0, f"mismatch: {n_bad} lanes differ"
    print(json.dumps({"exactness": "ok"}), flush=True)

    rng = np.random.default_rng(1)
    a0 = torch.from_numpy(rng.integers(1, 200, B).astype(np.int32)).to(dev)
    h0 = torch.from_numpy(rng.integers(0, H, B).astype(np.int32)).to(dev)
    o1 = timed_loop(plain, "torch_3p", a0, h0, cfg, card_line)
    o2 = timed_loop(kernel, "cuda_3p", a0, h0, cfg, card_line)
    assert torch.equal(o1, o2), "loop outputs differ"


if __name__ == "__main__":
    main()
