"""KF and KP, the port's probe kernels, against the TPU probes.

* KF's plain version (the wrapper with CPU tensors), its prepared form
  (``HotFetch``: the lane's work on the interleaved table in torch, and
  the g++ host build of the lane) and the one-shot host build against
  ``bench_micro/micro_pallas.py:make_xla_fetch`` (the twin
  its own exactness check uses; its Pallas kernel has no interpret
  switch) and ``bench_micro/micro_ablate.py:fetch_full`` with the
  select on, and ``fetch_matmul_only(a, h) ^ h`` with it off, on inputs
  that include ``a = 0``, ``a >= 256``, negative values and ``h``
  outside ``[0, H)``; also the chained loops of both scripts, and one
  and two planes against the low bytes of the three-plane fetch.
* The port's torch ablation variants against the JAX ones.
* KP's plain version and the host builds of both forms' lane bodies
  (the L2 form's, and the shared-memory form's on a staged copy of the
  planes with the ring loaded ahead) against the Pallas kernel of
  ``bench_micro/micro_fused.py`` in interpret mode, on the module's own
  ring and on one with zeros, values >= 256, negatives and start states
  out of range written in; KP's size rule (``plan``) on both sides of
  the shared-memory limit.
* The wrappers' input checks, and both kernels against their plain
  versions on a card (skipped without one).

The JAX scripts fix their sizes from ``MB_*`` at import, so they are
loaded by file path with small sizes set.  All values are integers:
every comparison is exact.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datok_tpu_torch.bench_micro import micro_ablate as port_ablate
from datok_tpu_torch.bench_micro import micro_pallas as port_pallas
from datok_tpu_torch.bench_micro.planes import (fetch_inputs,
                                                fetch_planes_from_numpy,
                                                fused_inputs,
                                                fused_planes_from_numpy,
                                                require_cuda)
from datok_tpu_torch.kernels.hot_fetch import (HotFetch, hot_fetch,
                                               hot_fetch_host,
                                               hot_fetch_plain)
from datok_tpu_torch.kernels.micro_fused import (SMEM_LIMIT, Plan,
                                                 micro_fused,
                                                 micro_fused_host,
                                                 micro_fused_plain,
                                                 micro_fused_staged_host, plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, BL, K = 256, 128, 128, 8
ENV = {"MB_B": str(B), "MB_H": str(H), "MB_BL": str(BL), "MB_K": str(K),
       "MB_STEPS": "4", "MB_INTERPRET": "1"}


def _load(name):
    path = os.path.join(ROOT, "bench_micro", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probes():
    """The three JAX probe modules at the small sizes of ``ENV``."""
    saved = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mods = {n: _load(n) for n in ("micro_pallas", "micro_fused",
                                      "micro_ablate")}
    sys.path[:] = saved
    return mods


@pytest.fixture(scope="module")
def fetch_case():
    """The scripts' planes and lanes with ``a`` over -4..300 and ``h``
    over -2..H+2, plus the edge values themselves."""
    planes, _, _ = fetch_inputs(B, H)
    rng = np.random.default_rng(11)
    a = rng.integers(-4, 301, B).astype(np.int32)
    h = rng.integers(-2, H + 3, B).astype(np.int32)
    a[:6] = [0, -1, 255, 256, 300, 1]
    h[:6] = [3, 3, -1, 5, H, H - 1]
    return planes, a, h


def _prepared(a, h, planes, n_planes, select):
    return HotFetch(planes, n_planes, select)(a, h)


def _prepared_host(a, h, planes, n_planes, select):
    return HotFetch(planes, n_planes, select).host(a, h)


FETCHERS = {"wrapper_cpu": hot_fetch, "host_build": hot_fetch_host,
            "prepared": _prepared, "prepared_host": _prepared_host}


def _port_fetch(fn, planes, a, h, select=True, n_planes=3):
    out = fn(torch.from_numpy(a), torch.from_numpy(h),
             fetch_planes_from_numpy(planes), n_planes, select)
    return out.numpy()


def test_probe_inputs_rebuilt_exactly(probes):
    planes, _, _ = fetch_inputs(B, H)
    np.testing.assert_array_equal(planes, probes["micro_ablate"].planes_np)
    table, planes_i8, ring, h0 = fused_inputs(B, H)
    mf = probes["micro_fused"]
    np.testing.assert_array_equal(table, mf.table)
    np.testing.assert_array_equal(planes_i8, mf.planes_i8)
    np.testing.assert_array_equal(ring, mf.ring_np)
    np.testing.assert_array_equal(h0, mf.h0_np)


@pytest.mark.parametrize("fn", FETCHERS.values(), ids=FETCHERS.keys())
def test_kf_select_matches_jax(probes, fetch_case, fn):
    planes, a, h = fetch_case
    got = _port_fetch(fn, planes, a, h)
    xla = probes["micro_pallas"].make_xla_fetch(planes, H)
    np.testing.assert_array_equal(got, np.asarray(xla(jnp.asarray(a), jnp.asarray(h))))
    full = probes["micro_ablate"].fetch_full(jnp.asarray(a), jnp.asarray(h))
    np.testing.assert_array_equal(got, np.asarray(full))
    assert (got[:2] == 0).all() and (got[3:5] == 0).all() and got[2] == 0


@pytest.mark.parametrize("fn", FETCHERS.values(), ids=FETCHERS.keys())
def test_kf_no_select_matches_jax(probes, fetch_case, fn):
    planes, a, h = fetch_case
    got = _port_fetch(fn, planes, a, h, select=False)
    ja, jh = jnp.asarray(a), jnp.asarray(h)
    want = probes["micro_ablate"].fetch_matmul_only(ja, jh) ^ jh
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[2] == planes[255, 0] and got[5] == planes[1, 0]


@pytest.mark.parametrize("fn", FETCHERS.values(), ids=FETCHERS.keys())
@pytest.mark.parametrize("n_planes", [1, 2])
def test_kf_n_planes_match_jax(probes, fetch_case, n_planes, fn):
    # micro_ablate.make_pallas(n_planes) multiplies the first n_planes*H
    # columns: its entry is the low 8*n_planes bits of the full fetch's
    planes, a, h = fetch_case
    sub = np.ascontiguousarray(planes[:, :n_planes * H])
    ja, jh = jnp.asarray(a), jnp.asarray(h)
    full = np.asarray(probes["micro_ablate"].fetch_full(ja, jh))
    got = _port_fetch(fn, sub, a, h, True, n_planes)
    np.testing.assert_array_equal(got, full & ((1 << (8 * n_planes)) - 1))
    got0 = _port_fetch(fn, sub, a, h, False, n_planes)
    want0 = probes["micro_ablate"].fetch_matmul_only(ja, jh) ^ jh
    np.testing.assert_array_equal(got0, np.asarray(want0))


def test_kf_prepared_words():
    planes = torch.arange(256 * 6, dtype=torch.int32).reshape(256, 6)
    planes = (planes % 251).to(torch.uint8)
    f = HotFetch(planes, 3, True)
    assert tuple(f.table.shape) == (256, 2, 4) and f.table.dtype == torch.uint8
    assert tuple(f.words.shape) == (256, 2) and f.words.dtype == torch.int32
    p = planes.to(torch.int32)
    assert f.table[7, 1].tolist() == [int(p[7, 1]), int(p[7, 3]), int(p[7, 5]), 0]
    assert int(f.words[7, 1]) == int(p[7, 1] | p[7, 3] << 8 | p[7, 5] << 16)
    f0 = HotFetch(planes, 3, False)
    assert tuple(f0.table.shape) == (256, 1, 4)
    assert torch.equal(f0.table[:, 0, :3], planes[:, 0::2])
    # the lane joins only its n_planes bytes and masks a = 0 itself:
    # bytes written above them, and into row 0, change nothing
    f2 = HotFetch(planes[:, :4].contiguous(), 2, True)
    a = torch.tensor([0, 7, 7, 255], dtype=torch.int32)
    h = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    want = f2.host(a, h)
    assert [int(x) for x in want] == [0, int(p[7, 0] | p[7, 2] << 8),
                                      int(p[7, 1] | p[7, 3] << 8),
                                      int(p[255, 1] | p[255, 3] << 8)]
    f2.table[:, :, 2:] = 0xAB
    f2.table[0] = 0x5C
    assert torch.equal(f2.host(a, h), want) and torch.equal(f2.plain(a, h), want)
    with pytest.raises(ValueError):  # lanes on another device
        f(torch.zeros(4, dtype=torch.int32, device="meta"),
          torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):
        f(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))


def _jax_chain(fetch, a, h, steps, update_h):
    a, h = jnp.asarray(a), jnp.asarray(h)
    acc = jnp.zeros_like(a)
    for _ in range(steps):
        entry = fetch(a, h)
        a, h, acc = (a + 1) & 255, update_h(entry), acc ^ entry
    return np.asarray(acc)


@pytest.mark.parametrize("fn", FETCHERS.values(), ids=FETCHERS.keys())
@pytest.mark.parametrize("script", ["micro_pallas", "micro_ablate"])
def test_kf_chained_loop_matches_jax(probes, fetch_case, script, fn):
    planes, a, h = fetch_case
    steps = 4
    tp = fetch_planes_from_numpy(planes)

    def port_fetch(x, y):
        return fn(x, y, tp, 3, True)

    a0, h0 = torch.from_numpy(a), torch.from_numpy(h)
    if script == "micro_pallas":
        got = port_pallas.chain(port_fetch, a0, h0, steps, H)
        want = _jax_chain(probes[script].make_xla_fetch(planes, H), a, h,
                          steps, lambda e: (e >> 5) & (H - 1))
    else:
        got = port_ablate.chain(port_fetch, a0, h0, steps, H)
        want = _jax_chain(probes[script].fetch_full, a, h, steps,
                          lambda e: (e >> 5) % H)
    np.testing.assert_array_equal(got.numpy(), want)


ABLATIONS = {"noop": "fetch_noop", "onehot_only": "fetch_onehot_only",
             "matmul_only": "fetch_matmul_only",
             "select_only": "fetch_select_only", "full_xla": "fetch_full"}


@pytest.mark.parametrize("variant", ABLATIONS)
def test_ablation_variants_match_jax(probes, fetch_case, variant):
    planes, a, h = fetch_case
    port_fn = port_ablate.variants(planes, H, "cpu")[variant]
    jax_fn = getattr(probes["micro_ablate"], ABLATIONS[variant])
    got = port_ablate.chain(port_fn, torch.from_numpy(a), torch.from_numpy(h), 3, H)
    want = _jax_chain(jax_fn, a, h, 3, lambda e: (e >> 5) % H)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ablation_kernel_variants_equal_their_plain_forms(fetch_case):
    planes, a, h = fetch_case
    v = port_ablate.variants(planes, H, "cpu")
    a0 = torch.from_numpy(a).clamp(0, 255)
    h0 = torch.from_numpy(h).clamp(0, H - 1)
    assert torch.equal(v["cuda_full"](a0, h0), v["full_xla"](a0, h0))
    assert torch.equal(port_ablate.two_steps(v["cuda_full"], a0, h0, H),
                       port_ablate.two_steps(v["full_xla"], a0, h0, H))
    assert torch.equal(v["cuda_matmul_only"](a0, h0),
                       v["matmul_only"](a0, h0) ^ h0)


@pytest.fixture(scope="module")
def fused_cases(probes):
    """Per ring case: the inputs and the Pallas kernel's (ys, h) in
    interpret mode."""
    mf = probes["micro_fused"]
    rng = np.random.default_rng(12)
    ring_edge = mf.ring_np.copy()
    ring_edge[rng.random(ring_edge.shape) < 0.05] = 0
    ring_edge[rng.random(ring_edge.shape) < 0.05] = 256
    ring_edge[rng.random(ring_edge.shape) < 0.03] = 1000
    ring_edge[rng.random(ring_edge.shape) < 0.03] = -7
    ring_edge[0, :4] = [0, 256, -1, 255]
    h0_edge = mf.h0_np.copy()
    h0_edge[:4] = [-1, H, H + 5, 0]
    out = {}
    for case, ring, h0 in (("module_ring", mf.ring_np, mf.h0_np),
                           ("edge_ring", ring_edge, h0_edge)):
        ys, hout = mf.run(jnp.asarray(ring), jnp.asarray(h0[None, :]))
        out[case] = (ring, h0, np.asarray(ys), np.asarray(hout))
    return out


KP_FNS = {"wrapper_cpu": micro_fused, "host_build": micro_fused_host,
          "staged_host": micro_fused_staged_host}


@pytest.mark.parametrize("fn", KP_FNS.values(), ids=KP_FNS.keys())
@pytest.mark.parametrize("case", ["module_ring", "edge_ring"])
def test_kp_matches_pallas_interpret(probes, fused_cases, case, fn):
    ring, h0, ys_ref, h_ref = fused_cases[case]
    planes = fused_planes_from_numpy(probes["micro_fused"].planes_i8)
    ys, hout = fn(torch.from_numpy(ring), planes,
                  torch.from_numpy(h0[None, :]), K)
    np.testing.assert_array_equal(ys.numpy(), ys_ref)
    np.testing.assert_array_equal(hout.numpy(), h_ref)
    if case == "edge_ring":
        # a symbol outside 1..255 reads nothing: entry 0x8080 at step 0
        assert [int(x) for x in ys[0, :3]] == [0x8080] * 3
    else:
        # where every symbol is in range the script's numpy replay agrees
        ys_np, h_np = probes["micro_fused"].numpy_replay()
        np.testing.assert_array_equal(ys.numpy(), ys_np)
        np.testing.assert_array_equal(hout.numpy()[0], h_np)


@pytest.mark.parametrize("R,K", [(1, 1), (3, 17), (5, 37), (128, 64)])
def test_kp_staged_lane_wraps_ring(R, K):
    # the ring window refilled every W steps, the ring wrapping at R rows
    rng = np.random.default_rng(13)
    Hs, Bs = 40, 33
    ring = torch.from_numpy(rng.integers(-3, 300, (R, Bs)).astype(np.int32))
    planes = torch.from_numpy(rng.integers(-128, 128, (2 * Hs, 256)).astype(np.int8))
    h0 = torch.from_numpy(rng.integers(-2, Hs + 2, (1, Bs)).astype(np.int32))
    want = micro_fused_plain(ring, planes, h0, K)
    got = micro_fused_host(ring, planes, h0, K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for rows in (1, 3, 16, 64):
        got = micro_fused_staged_host(ring, planes, h0, K, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B", [1, 16384, 200000])
@pytest.mark.parametrize("H", [384, 453, 454, 455, 512, 2047])
def test_kp_plan_size_rule(H, B):
    n_sm, K = 132, 64
    p = plan(H, B, K, n_sm)
    assert p.smem <= SMEM_LIMIT
    if H >= 454:  # the planes alone leave no room
        assert p == Plan("l2", -(-B // 256), 256, 0, 0)
        return
    lanes = -(-B // n_sm)
    threads = min(max(32, -(-lanes // 32) * 32), 256)
    room = SMEM_LIMIT - 16 - 2 * H * 256
    if room < 4 * threads:  # not one row of the ring window
        assert H == 453 and B > 1 and p.form == "l2"
        return
    assert p.form == "smem" and p.threads == threads
    assert p.ring_rows == min(K, room // (4 * threads))
    assert p.smem == 2 * H * 256 + 4 * p.ring_rows * p.threads + 16
    assert 1 <= p.grid <= n_sm
    # every lane has a thread, or every SM a block of 256 that loops
    assert p.grid * p.threads >= B or (p.threads == 256 and p.grid == n_sm)
    assert (p.grid - 1) * p.threads < B  # no block without lanes
    if (H, B) == (384, 16384):
        assert (p.grid, p.threads, p.ring_rows) == (128, 128, 64)
    if (H, B) == (384, 200000):  # threads loop, and refill their window
        assert (p.grid, p.threads, p.ring_rows) == (132, 256, 34)


def test_planes_from_numpy_reject_bad_values():
    with pytest.raises(ValueError):
        fetch_planes_from_numpy(np.full((256, 6), 256.0, np.float32))
    with pytest.raises(ValueError):
        fetch_planes_from_numpy(np.full((256, 6), 1.5, np.float32))
    with pytest.raises(ValueError):
        fetch_planes_from_numpy(np.zeros((255, 6), np.float32))
    with pytest.raises(TypeError):
        fused_planes_from_numpy(np.zeros((8, 256), np.int16))
    with pytest.raises(ValueError):
        fused_planes_from_numpy(np.zeros((7, 256), np.int8))


def _kf_args():
    return [torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
            torch.zeros((256, 3 * 4), dtype=torch.uint8)]


def _kp_args():
    return [torch.zeros((4, 8), dtype=torch.int32),
            torch.zeros((8, 256), dtype=torch.int8),
            torch.zeros((1, 8), dtype=torch.int32)]


@pytest.mark.parametrize("bad", ["a_dtype", "h_shape", "planes_rows",
                                 "planes_dtype", "noncontiguous", "n_planes",
                                 "device"])
def test_kf_rejects_bad_inputs(bad):
    args, kw, err = _kf_args(), {}, ValueError
    if bad == "a_dtype":
        args[0], err = args[0].long(), TypeError
    elif bad == "h_shape":
        args[1] = args[1][:4]
    elif bad == "planes_rows":
        args[2] = args[2][:255]
    elif bad == "planes_dtype":
        args[2], err = args[2].to(torch.int8), TypeError
    elif bad == "noncontiguous":
        args[0] = torch.zeros((8, 2), dtype=torch.int32)[:, 0]
    elif bad == "n_planes":
        kw = {"n_planes": 5}
    else:
        args = [x.to("meta") for x in args]
    with pytest.raises(err):
        hot_fetch(*args, **kw)


@pytest.mark.parametrize("bad", ["ring_dtype", "h0_shape", "planes_cols",
                                 "k_zero", "device"])
def test_kp_rejects_bad_inputs(bad):
    args, k, err = _kp_args(), 4, ValueError
    if bad == "ring_dtype":
        args[0], err = args[0].to(torch.int16), TypeError
    elif bad == "h0_shape":
        args[2] = args[2][0]
    elif bad == "planes_cols":
        args[1] = torch.zeros((8, 128), dtype=torch.int8)
    elif bad == "k_zero":
        k = 0
    else:
        args = [x.to("meta") for x in args]
    with pytest.raises(err):
        micro_fused(*args, k)


def test_probe_scripts_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        require_cuda()
    with pytest.raises(RuntimeError):
        port_pallas.main()


@pytest.mark.cuda
def test_kernels_match_plain_on_card(fetch_case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (KF and KP have no CPU mode)")
    dev = torch.device("cuda")
    planes, a, h = fetch_case
    tp = fetch_planes_from_numpy(planes, dev)
    ta, th = torch.from_numpy(a).to(dev), torch.from_numpy(h).to(dev)
    for select in (True, False):
        want = hot_fetch_plain(ta, th, tp, 3, select)
        prepared = HotFetch(tp, 3, select)
        for fetch in (lambda: hot_fetch(ta, th, tp, 3, select),
                      lambda: prepared(ta, th)):
            before = hot_fetch.launches
            got = fetch()
            torch.cuda.synchronize()
            assert hot_fetch.launches == before + 1
            assert torch.equal(got, want)
    # both of KP's forms: the planes in shared memory (H=128) and in L2;
    # then the shared-memory form where each thread walks further lanes
    # and refills its ring window (H=384, 200,000 lanes, 64 steps)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for Hk, Bk, Kk in ((H, B, K), (512, B, K), (384, 200000, 64)):
        _table, planes_i8, ring, h0 = fused_inputs(Bk, Hk)
        ring[0, :4] = [0, 256, -1, 255]
        h0[:2] = [-1, Hk]
        args = (torch.from_numpy(ring).to(dev),
                fused_planes_from_numpy(planes_i8, dev),
                torch.from_numpy(h0[None, :]).to(dev), Kk)
        p = plan(Hk, Bk, Kk, n_sm)
        assert p.form == ("l2" if Hk == 512 else "smem")
        if Bk == 200000:
            assert p.ring_rows < Kk and p.grid * p.threads < Bk
        before = micro_fused.launches
        ys, hout = micro_fused(*args)
        torch.cuda.synchronize()
        assert micro_fused.launches == before + 1
        ys_p, h_p = micro_fused_plain(*args)
        assert torch.equal(ys, ys_p) and torch.equal(hout, h_p)
