"""Wrapper of KF, the hot-plane fetch (``csrc/hot_fetch.cu``).

KF is the counterpart of the TPU probes' fetch kernels,
``bench_micro/micro_pallas.py:make_pallas_fetch`` and
``bench_micro/micro_ablate.py:make_pallas`` (see ``hot_fetch_lane.cuh``
for the function).  Tensors on the CPU go to :func:`hot_fetch_plain`;
tensors on a CUDA device go to KF, and anything KF does not take
raises.  ``hot_fetch.launches`` counts KF launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

N_SYMBOLS = 256  # rows of the planes (the probes' A_pad)


def _check(a, h, planes, n_planes):
    dev = a.device
    if planes.dim() != 2 or planes.shape[0] != N_SYMBOLS:
        raise ValueError(
            f"planes must be ({N_SYMBOLS}, n_planes*H), got {tuple(planes.shape)}")
    if not 1 <= n_planes <= 4:
        raise ValueError(f"n_planes must be 1..4, got {n_planes}")
    if planes.shape[1] % n_planes or planes.shape[1] == 0:
        raise ValueError(f"{planes.shape[1]} plane columns do not hold "
                         f"{n_planes} planes")
    if a.dim() != 1:
        raise ValueError(f"a must be (B,), got {tuple(a.shape)}")
    for name, x, dtype in (("a", a, torch.int32), ("h", h, torch.int32),
                           ("planes", planes, torch.uint8)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, a on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.shape != a.shape:
        raise ValueError(f"h must be {tuple(a.shape)}, got {tuple(h.shape)}")
    return planes.shape[1] // n_planes


def hot_fetch_plain(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
                    n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """KF's function in torch ops: masks and an index gather."""
    H = _check(a, h, planes, n_planes)
    valid = (a > 0) & (a < N_SYMBOLS)
    row = planes[torch.where(valid, a, 0).long()]  # (B, n_planes*H)
    if not select:
        return torch.where(valid, row[:, 0].to(torch.int32), 0)
    valid &= (h >= 0) & (h < H)
    col = torch.where(valid, h, 0).long()[:, None]
    entry = torch.zeros_like(a)
    for k in range(n_planes):
        byte = row.gather(1, col + k * H)[:, 0].to(torch.int32)
        entry |= byte << (8 * k)
    return torch.where(valid, entry, 0)


def _launch(lib_fn, a, h, planes, H, n_planes, select, out, *extra):
    rc = lib_fn(a.data_ptr(), h.data_ptr(), planes.data_ptr(), H, n_planes,
                int(select), a.shape[0], out.data_ptr(), *extra)
    if rc != 0:
        raise RuntimeError(f"KF returned {rc}")


def hot_fetch(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
              n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """The entry of each lane (``a``, ``h`` (B,) int32; ``planes``
    (256, n_planes*H) uint8); returns (B,) int32."""
    H = _check(a, h, planes, n_planes)
    dev = a.device
    if dev.type == "cpu":
        return hot_fetch_plain(a, h, planes, n_planes, select)
    if dev.type != "cuda":
        raise ValueError(f"KF runs on CUDA devices, not {dev}")
    lib = build.load(build.HOT_FETCH)
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.dt_hot_fetch_launch, a, h, planes, H, n_planes, select,
                out, ctypes.c_void_p(stream))
    hot_fetch.launches += 1
    return out


hot_fetch.launches = 0


def hot_fetch_host(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
                   n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """KF's lane body compiled for the host with g++ (tests only)."""
    H = _check(a, h, planes, n_planes)
    if a.device.type != "cpu":
        raise ValueError("the host build takes CPU tensors")
    out = torch.empty_like(a)
    _launch(build.load(build.MICRO_HOST).dt_hot_fetch_host, a, h, planes, H,
            n_planes, select, out)
    return out
