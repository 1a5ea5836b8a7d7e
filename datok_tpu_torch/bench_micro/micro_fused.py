"""Probe: the fused K-step loop on the card, KP against its plain version.

Counterpart of ``bench_micro/micro_fused.py``: the same ``MB_*`` knobs
and defaults (``MB_B`` 16384, ``MB_H`` 384, ``MB_BL`` 1024, kept for
the record, ``MB_K`` 64), the same seeded table, ring and start states,
the same exactness check of ``ys`` and ``h`` first (KP against the
plain torch loop, which follows the Pallas kernel), then the timing of
both, a single call each.  KP runs in the form that
``kernels/micro_fused.py:plan`` picks (the planes in shared memory at
the default H=384, in L2 where they and one ring-window row do not
fit).  ``MB_INTERPRET`` has no counterpart: the plain version is the
CPU form.

    python -m datok_tpu_torch.bench_micro.micro_fused

Prints one JSON line per result, each timing with the card's name and
power limit, and returns the timings; needs a GPU.
"""

from __future__ import annotations

import json
import os

import torch

from ..kernels.micro_fused import micro_fused, micro_fused_plain
from .planes import (card, cuda_ms, fused_inputs, fused_planes_from_numpy,
                     require_cuda)

REPS = 10


def config():
    env = os.environ.get
    return {"B": int(env("MB_B", "16384")), "H": int(env("MB_H", "384")),
            "BL": int(env("MB_BL", "1024")), "K": int(env("MB_K", "64"))}


def inputs(cfg, device):
    """``(ring (128, B), planes (2H, 256), h0 (1, B))`` on ``device``."""
    _table, planes_i8, ring, h0 = fused_inputs(cfg["B"], cfg["H"])
    return (torch.from_numpy(ring).to(device),
            fused_planes_from_numpy(planes_i8, device),
            torch.from_numpy(h0[None, :]).to(device))


def main():
    dev = require_cuda()
    cfg = config()
    card_line = card()
    B, K = cfg["B"], cfg["K"]
    ring, planes, h0 = inputs(cfg, dev)
    ys, hout = micro_fused(ring, planes, h0, K)
    ys_ref, h_ref = micro_fused_plain(ring, planes, h0, K)
    ok_ys, ok_h = bool(torch.equal(ys, ys_ref)), bool(torch.equal(hout, h_ref))
    print(json.dumps({"ys_exact": ok_ys, "h_exact": ok_h}), flush=True)
    if not (ok_ys and ok_h):
        raise RuntimeError("KP differs from the plain loop")

    results = []
    for tag, fn, reps in (("torch", micro_fused_plain, 1),
                          ("cuda", micro_fused, REPS)):
        ms, _ = cuda_ms(lambda: fn(ring, planes, h0, K), reps)
        results.append({
            "variant": tag, "B": B, "H": cfg["H"], "BL": cfg["BL"], "K": K,
            "ns_per_lane_step": ms * 1e6 / (B * K),
            "us_per_step": ms * 1e3 / K, "ms_per_call": ms, "card": card_line,
        })
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
