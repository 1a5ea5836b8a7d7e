"""KF and KP of one source tree of the port on the card, for A/B runs.

Runs the probe kernels of the port found under ``--root`` (a checkout
of this repository) at the TPU probes' default size, on
``chip_smoke.py``'s phase-6 inputs (out-of-range lanes included): KF
with the select on and off and KP, each first checked exactly against
its plain version, then timed per call (CUDA events, the mean of 100
calls after a warm-up) and by device time a call (``torch.profiler``
over 20 calls).  It uses entry points that every version of the port
has (KF through ``HotFetch`` where the tree has it, else
``hot_fetch``), so two trees compare in one call, each in its own
process, in turns (A, B, B, A)::

    python3 datok_tpu_torch/bench_micro/probe_turns.py --root build/parent
    python3 datok_tpu_torch/bench_micro/probe_turns.py --root . --shapes --host

``--shapes`` times KP's shared-memory form on fewer blocks and at K=1
(the fill with one step), each checked; ``--host`` times the stages of
one prepared KF call on the host clock, each alone over 20,000 calls.
Prints one JSON line with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def host_stages(fetch, a, h, n=20000):
    """Microseconds a call of each statement of ``HotFetch.__call__``,
    each timed alone over ``n`` calls between synchronizations, and of
    the whole call and of ``torch.take``."""
    B, idx, i32 = a.shape[0], fetch._index, torch.int32
    out = torch.empty(B, dtype=i32, device=fetch.device)
    words = fetch.words.reshape(-1)
    a_long = a.long().clamp(0, words.numel() - 1)

    def check():
        return (a.get_device() != idx or h.get_device() != idx
                or a.dtype is not i32 or h.dtype is not i32 or a.dim() != 1
                or h.shape != a.shape or not a.is_contiguous()
                or not h.is_contiguous())

    def launch(n=B):
        fetch._fn(a.data_ptr(), h.data_ptr(), out.data_ptr(), n,
                  fetch._table_ptr, fetch._stream(idx))

    stages = {
        "loop": lambda: None,
        "check": check,
        "empty_like": lambda: torch.empty_like(a),
        "data_ptr x3": lambda: (a.data_ptr(), h.data_ptr(), out.data_ptr()),
        "raw_stream": lambda: fetch._stream(idx),
        "ctypes_launch": launch,
        # the same ctypes call with B = 0, which returns before any CUDA call
        "ctypes_noop": lambda: launch(0),
        "call": lambda: fetch(a, h),
        "torch.take": lambda: torch.take(words, a_long),
    }
    res = {}
    for name, fn in stages.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / n * 1e6
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to run")
    ap.add_argument("--shapes", action="store_true",
                    help="KP's shared-memory form on fewer blocks, and at "
                         "K=1 (the fill with one step)")
    ap.add_argument("--host", action="store_true",
                    help="the host stages of one prepared KF call")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.root))

    import chip_smoke as cs
    from datok_tpu_torch.kernels import build
    from datok_tpu_torch.kernels import hot_fetch as hf
    from datok_tpu_torch.kernels import micro_fused as mf

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    build.build_all((build.HOT_FETCH, build.MICRO_FUSED))
    dev = torch.device("cuda")
    B, H, K = cs.PROBE_SHAPE
    (a, h, planes), (ring, planes_i8, h0) = cs.probe_inputs(dev)
    prepared = hasattr(hf, "HotFetch")

    def kf(select):
        if prepared:
            fetch = hf.HotFetch(planes, 3, select)
            return lambda: fetch(a, h)
        return lambda: hf.hot_fetch(a, h, planes, 3, select)

    cases = {
        "hot_fetch[select]": (kf(True), lambda: hf.hot_fetch_plain(a, h, planes, 3, True)),
        "hot_fetch[no_select]": (kf(False), lambda: hf.hot_fetch_plain(a, h, planes, 3, False)),
        "micro_fused": (lambda: mf.micro_fused(ring, planes_i8, h0, K),
                        lambda: mf.micro_fused_plain(ring, planes_i8, h0, K)),
    }
    out = {"root": opts.root, "card": card, "prepared_kf": prepared}
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = cs.exact_err(got, want)
        if err:
            raise RuntimeError(f"{name} differs from its plain version ({err})")
        ms, _ = cs.cuda_ms(kern, n=100, warmup=2)
        out[name] = {"ms": ms, "device_us": cs.device_us(kern)}

    if opts.shapes:
        want = {k: mf.micro_fused_plain(ring, planes_i8, h0, k) for k in (1, K)}
        shapes = {}
        for n_blocks in (132, 96, 64, 48, 32):
            p = mf.plan(H, B, K, n_blocks)
            for k in (1, K):
                def run(p=p, k=k):
                    return mf.launch(ring, planes_i8, h0, k, p)

                err = cs.exact_err(run(), want[k])
                if err:
                    raise RuntimeError(f"KP {p} K={k} differs ({err})")
                shapes[f"{p.grid}x{p.threads} K{k}"] = cs.device_us(run)
        out["kp_shapes_device_us"] = shapes
    if opts.host and prepared:
        out["kf_host_us"] = {
            mode: host_stages(hf.HotFetch(planes, 3, sel), a, h)
            for mode, sel in (("select", True), ("no_select", False))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
