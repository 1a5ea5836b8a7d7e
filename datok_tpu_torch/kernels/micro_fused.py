"""Wrapper of KP, the fused probe loop (``csrc/micro_fused.cu``).

KP is the counterpart of the TPU probe kernel of
``bench_micro/micro_fused.py`` (see ``micro_fused_lane.cuh`` for the
walk).  Tensors on the CPU go to :func:`micro_fused_plain`; tensors on
a CUDA device go to KP, and anything KP does not take raises.  KP has
two forms, and :func:`plan` picks one by a size rule: the planes in
each block's shared memory where the planes (2H x 256 bytes), at least
one row of the block's ring window (4 bytes a thread) and its mbarrier
fit one block's 232,448 bytes, else in L2.
``micro_fused.launches`` counts KP launches (either form).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import build

N_SYMBOLS = 256  # columns of the planes (the probe's A_pad)
HOT_MASK = (1 << 11) - 1
SMEM_LIMIT = 232_448  # one block's shared memory on Hopper (227 KB)
BAR_BYTES = 16  # the block's mbarrier, after the planes and the window
# threads a block of the shared-memory form, at most: more lanes an SM
# loop, so that the ring window keeps rows beside the planes
SMEM_THREADS = 256
L2_THREADS = 256


@dataclass(frozen=True)
class Plan:
    """A launch of KP: its form ("smem" or "l2"), grid, threads a
    block, bytes of dynamic shared memory, and rows of the ring window
    (steps whose ring words a lane holds at once)."""

    form: str
    grid: int
    threads: int
    smem: int
    ring_rows: int


def plan(H: int, B: int, K: int, n_sm: int) -> Plan:
    """KP's launch for ``H`` rows a plane, ``B`` lanes and ``K`` steps
    on a card of ``n_sm`` SMs.  The shared-memory form: one persistent
    block an SM (the planes leave room for no second), ceil(B / n_sm)
    lanes a block rounded up to a warp, at most 256 (a thread then loops
    over further lanes), and a ring window of as many of the K steps as
    the rest of the block's shared memory holds; where not even one row
    fits, the L2 form, one lane a thread in 256-thread blocks."""
    per_block = -(-B // n_sm)
    threads = max(32, min(-(-per_block // 32) * 32, SMEM_THREADS))
    planes = 2 * H * N_SYMBOLS
    rows = min(K, max(0, SMEM_LIMIT - BAR_BYTES - planes) // (4 * threads))
    if rows < 1:
        return Plan("l2", max(1, -(-B // L2_THREADS)), L2_THREADS, 0, 0)
    grid = min(n_sm, max(1, -(-B // threads)))
    return Plan("smem", grid, threads, planes + 4 * rows * threads + BAR_BYTES,
                rows)


def _check(ring, planes, h0, K):
    dev = ring.device
    if ring.dim() != 2 or ring.shape[0] < 1:
        raise ValueError(f"ring must be (R, B), got {tuple(ring.shape)}")
    R, B = ring.shape
    if planes.dim() != 2 or planes.shape[1] != N_SYMBOLS or planes.shape[0] % 2 \
            or planes.shape[0] == 0:
        raise ValueError(f"planes must be (2H, {N_SYMBOLS}), got "
                         f"{tuple(planes.shape)}")
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    for name, x, dtype in (("ring", ring, torch.int32),
                           ("planes", planes, torch.int8),
                           ("h0", h0, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, ring on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(h0.shape) != (1, B):
        raise ValueError(f"h0 must be (1, {B}), got {tuple(h0.shape)}")
    return R, B, planes.shape[0] // 2


def micro_fused_plain(ring: torch.Tensor, planes: torch.Tensor,
                      h0: torch.Tensor, K: int):
    """KP's walk as a torch loop over the K steps."""
    R, B, H = _check(ring, planes, h0, K)
    lane = torch.arange(B, device=ring.device)
    h = h0[0].clone()
    c = torch.zeros(B, dtype=torch.long, device=ring.device)
    ys = torch.empty((K, B), dtype=torch.int32, device=ring.device)
    for i in range(K):
        a = ring[c, lane]
        valid = (a > 0) & (a < N_SYMBOLS) & (h >= 0) & (h < H)
        ai = torch.where(valid, a, 0).long()
        hi_row = torch.where(valid, h, 0).long()
        lo = torch.where(valid, planes[hi_row, ai].to(torch.int32), 0) + 128
        hi = torch.where(valid, planes[hi_row + H, ai].to(torch.int32), 0) + 128
        entry = lo | (hi << 8)
        h_new = entry & HOT_MASK
        h_new = torch.where(h_new >= H, h_new - H, h_new)
        h = torch.where(h_new >= H, 0, h_new)
        ys[i] = entry ^ i
        c = (c + 1) % R
    return ys, h[None, :].clone()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(ring: torch.Tensor, planes: torch.Tensor, h0: torch.Tensor,
           K: int, p: Plan):
    """KP on the card in the form and shape ``p`` (from :func:`plan`)
    for inputs that :func:`micro_fused` has checked."""
    R, B = ring.shape
    if p.smem and planes.data_ptr() % 16:
        raise ValueError("the planes' bulk copy needs 16-byte aligned planes")
    dev = ring.device
    ys = torch.empty((K, B), dtype=torch.int32, device=dev)
    h_out = torch.empty((1, B), dtype=torch.int32, device=dev)
    rc = build.load(build.MICRO_FUSED).dt_micro_fused_launch(
        ring.data_ptr(), R, B, planes.data_ptr(), planes.shape[0] // 2, K,
        h0.data_ptr(), ys.data_ptr(), h_out.data_ptr(), p.grid, p.threads,
        p.smem, p.ring_rows, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"KP launch failed ({p}): CUDA error {rc}")
    micro_fused.launches += 1
    return ys, h_out


def micro_fused(ring: torch.Tensor, planes: torch.Tensor, h0: torch.Tensor,
                K: int):
    """K steps of every lane (``ring`` (R, B) int32, ``planes`` (2H, 256)
    int8, ``h0`` (1, B) int32); returns ``(ys (K, B), h (1, B))`` int32."""
    R, B, H = _check(ring, planes, h0, K)
    dev = ring.device
    if dev.type == "cpu":
        return micro_fused_plain(ring, planes, h0, K)
    if dev.type != "cuda":
        raise ValueError(f"KP runs on CUDA devices, not {dev}")
    return launch(ring, planes, h0, K, plan(H, B, K, sm_count(dev.index)))


micro_fused.launches = 0


def _host(entry, ring, planes, h0, K, *extra):
    R, B, H = _check(ring, planes, h0, K)
    if ring.device.type != "cpu":
        raise ValueError("the host build takes CPU tensors")
    ys = torch.empty((K, B), dtype=torch.int32)
    h_out = torch.empty((1, B), dtype=torch.int32)
    rc = getattr(build.load(build.MICRO_HOST), entry)(
        ring.data_ptr(), R, B, planes.data_ptr(), H, K, h0.data_ptr(),
        ys.data_ptr(), h_out.data_ptr(), *extra)
    if rc != 0:
        raise ValueError(f"{entry} does not take H={H}")
    return ys, h_out


def micro_fused_host(ring: torch.Tensor, planes: torch.Tensor,
                     h0: torch.Tensor, K: int):
    """KP's L2-form lane body compiled for the host with g++ (tests
    only)."""
    return _host("dt_micro_fused_host", ring, planes, h0, K)


def micro_fused_staged_host(ring: torch.Tensor, planes: torch.Tensor,
                            h0: torch.Tensor, K: int, ring_rows: int = 16):
    """KP's shared-memory-form lane body compiled for the host with g++,
    on a staged copy of the planes and a ring window of ``ring_rows``
    rows (tests only)."""
    return _host("dt_micro_fused_staged_host", ring, planes, h0, K,
                 ring_rows)
