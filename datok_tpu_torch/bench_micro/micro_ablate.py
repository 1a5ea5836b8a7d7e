"""Probe: ablations of the hot-entry fetch on the card.

Counterpart of ``bench_micro/micro_ablate.py``: the same ``MB_*`` knobs
and defaults (``MB_B`` 16384, ``MB_H`` 384, ``MB_BL`` 1024, kept for
the record, ``MB_STEPS`` 64), the same one-step and two-step checks of
the kernel against the full one-hot fetch, then the same chained loop
(``h' = (entry >> 5) % H``) timed for each variant.  The one-hot
variants (``noop``, ``onehot_only``, ``matmul_only``, ``select_only``,
``full_xla``) were XLA on the TPU and are plain torch functions here;
the Pallas variants are KF, prepared once (``HotFetch``), with the
select on (``cuda_full``) and off (``cuda_matmul_only``).  As the TPU
ran each loop as one jitted ``fori_loop``, each variant's loop is
captured in one CUDA graph and its replays are timed (``us_per_step``,
``ns_per_lane_step``), beside the loop launched step by step from
Python (``eager_us_per_step``); KF's rows also count the KF launches
their replays ran (``graph_launches``: the replays times the graph's KF
nodes).

    python -m datok_tpu_torch.bench_micro.micro_ablate

Prints one JSON line per result, each timing with the card's name and
power limit, and returns the timings; needs a GPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..kernels.hot_fetch import KERNEL_NAME, HotFetch
from .planes import (N_SYMBOLS, card, chain_times, fetch_inputs,
                     fetch_planes_from_numpy, require_cuda)

REPS = 5


def config():
    env = os.environ.get
    return {"B": int(env("MB_B", "16384")), "H": int(env("MB_H", "384")),
            "BL": int(env("MB_BL", "1024")), "STEPS": int(env("MB_STEPS", "64"))}


def chain(fetch, a0: torch.Tensor, h0: torch.Tensor, steps: int, H: int):
    """The probe's loop (micro_ablate.py:56-68): XOR of the entries of
    ``steps`` chained fetches, ``h' = (entry >> 5) % H``,
    ``a' = (a + 1) & 255``."""
    a, h, acc = a0, h0, torch.zeros_like(a0)
    for _ in range(steps):
        entry = fetch(a, h)
        a, h, acc = (a + 1) & (N_SYMBOLS - 1), (entry >> 5) % H, acc ^ entry
    return acc


def two_steps(fetch, a, h, H: int):
    """The second of two chained fetches (micro_ablate.py:156-163)."""
    e1 = fetch(a, h)
    return fetch((a + 1) & (N_SYMBOLS - 1), (e1 >> 5) % H)


def variants(planes_f32: np.ndarray, H: int, device):
    """The ablation fetches of micro_ablate.py:74-108 in torch ops (the
    one-hot rows in bf16, as on the TPU; every value is an integer
    below 2^8, so the products are exact), and KF's two forms."""
    planes_bf = torch.from_numpy(planes_f32).to(device, torch.bfloat16)
    planes_u8 = fetch_planes_from_numpy(planes_f32, device)
    iota_a = torch.arange(N_SYMBOLS, dtype=torch.int32, device=device)
    iota_h = torch.arange(H, dtype=torch.int32, device=device)
    i32 = torch.int32

    def onehot(a):
        return ((a[:, None] == iota_a[None, :]) & (a > 0)[:, None]).to(torch.bfloat16)

    def select(rows, h):
        msel = iota_h[None, :] == h[:, None]
        out = torch.zeros_like(h)
        for k in range(3):
            part = torch.where(msel, rows[:, k * H:(k + 1) * H], 0.0)
            out |= part.sum(dim=1).to(i32) << (8 * k)
        return out

    def fetch_full(a, h):
        return select((onehot(a) @ planes_bf).float(), h)

    def fetch_matmul_only(a, h):
        return (onehot(a) @ planes_bf).float()[:, 0].to(i32) ^ h

    def fetch_onehot_only(a, h):
        return onehot(a).float().sum(dim=1).to(i32) ^ h

    def fetch_select_only(a, h):
        cols = torch.arange(3 * H, dtype=i32, device=device)
        return select((a[:, None] + cols[None, :]).float(), h)

    def fetch_noop(a, h):
        return a ^ h

    return {
        "noop": fetch_noop,
        "onehot_only": fetch_onehot_only,
        "matmul_only": fetch_matmul_only,
        "select_only": fetch_select_only,
        "full_xla": fetch_full,
        "cuda_full": HotFetch(planes_u8, 3, True),
        "cuda_matmul_only": HotFetch(planes_u8, 3, False),
    }


def main():
    dev = require_cuda()
    cfg = config()
    card_line = card()
    B, H, steps = cfg["B"], cfg["H"], cfg["STEPS"]
    planes_np, a_np, h_np = fetch_inputs(B, H)
    fetch = variants(planes_np, H, dev)
    a = torch.from_numpy(a_np).to(dev)
    h = torch.from_numpy(h_np).to(dev)
    full, kf = fetch["full_xla"], fetch["cuda_full"]
    n1 = int((full(a, h) != kf(a, h)).sum())
    print(json.dumps({"single_call_mismatches": n1}), flush=True)
    n2 = int((two_steps(full, a, h, H) != two_steps(kf, a, h, H)).sum())
    print(json.dumps({"two_step_mismatches": n2}), flush=True)
    if n1 or n2:
        raise RuntimeError("KF differs from the one-hot fetch")

    rng = np.random.default_rng(1)
    a0 = torch.from_numpy(rng.integers(1, 200, B).astype(np.int32)).to(dev)
    h0 = torch.from_numpy(rng.integers(0, H, B).astype(np.int32)).to(dev)
    results = []
    for tag, fn in fetch.items():
        kernel = KERNEL_NAME if isinstance(fn, HotFetch) else ""
        eager, graph, _, replayed = chain_times(
            lambda: chain(fn, a0, h0, steps, H), REPS, kernel)
        results.append({
            "variant": tag, "B": B,
            "ns_per_lane_step": graph * 1e6 / (B * steps),
            "us_per_step": graph * 1e3 / steps,
            "eager_us_per_step": eager * 1e3 / steps,
            "graph_launches": replayed, "card": card_line,
        })
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
