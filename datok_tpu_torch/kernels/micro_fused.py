"""Wrapper of KP, the fused probe loop (``csrc/micro_fused.cu``).

KP is the counterpart of the TPU probe kernel of
``bench_micro/micro_fused.py`` (see ``micro_fused_lane.cuh`` for the
walk).  Tensors on the CPU go to :func:`micro_fused_plain`; tensors on
a CUDA device go to KP, and anything KP does not take raises.
``micro_fused.launches`` counts KP launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

N_SYMBOLS = 256  # columns of the planes (the probe's A_pad)
HOT_MASK = (1 << 11) - 1


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


def _launch(lib_fn, ring, planes, h0, K, ys, h_out, *extra):
    R, B = ring.shape
    rc = lib_fn(ring.data_ptr(), R, B, planes.data_ptr(), planes.shape[0] // 2,
                K, h0.data_ptr(), ys.data_ptr(), h_out.data_ptr(), *extra)
    if rc != 0:
        raise RuntimeError(f"KP returned {rc}")


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
    lib = build.load(build.MICRO_FUSED)
    ys = torch.empty((K, B), dtype=torch.int32, device=dev)
    h_out = torch.empty((1, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.dt_micro_fused_launch, ring, planes, h0, K, ys, h_out,
                ctypes.c_void_p(stream))
    micro_fused.launches += 1
    return ys, h_out


micro_fused.launches = 0


def micro_fused_host(ring: torch.Tensor, planes: torch.Tensor,
                     h0: torch.Tensor, K: int):
    """KP's lane body compiled for the host with g++ (tests only)."""
    R, B, H = _check(ring, planes, h0, K)
    if ring.device.type != "cpu":
        raise ValueError("the host build takes CPU tensors")
    ys = torch.empty((K, B), dtype=torch.int32)
    h_out = torch.empty((1, B), dtype=torch.int32)
    _launch(build.load(build.MICRO_HOST).dt_micro_fused_host, ring, planes,
            h0, K, ys, h_out)
    return ys, h_out
