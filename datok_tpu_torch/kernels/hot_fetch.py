"""Wrapper of KF, the hot-plane fetch (``csrc/hot_fetch.cu``).

KF is the counterpart of the TPU probes' fetch kernels,
``bench_micro/micro_pallas.py:make_pallas_fetch`` and
``bench_micro/micro_ablate.py:make_pallas`` (see ``hot_fetch_lane.cuh``
for the function).  Like them, :class:`HotFetch` prepares its table once
(``HotFetch(planes, n_planes, select)``: the planes checked and
interleaved into a table of 4-byte words) and returns a callable
``fetch(a, h)`` whose call checks only ``a`` and ``h`` and launches KF.
:func:`hot_fetch` is the checked one-shot entry (it prepares on every
call).  Tensors on the CPU go to the plain versions; tensors on a CUDA
device go to KF, and anything KF does not take raises.
``hot_fetch.launches`` counts KF launches: each call of the launcher
that enqueued KF, the one that a CUDA-graph capture records included.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

N_SYMBOLS = 256  # rows of the planes (the probes' A_pad)
KERNEL_NAME = "hot_fetch_kernel"  # KF's name in a profiler's trace


def _check_planes(planes, n_planes):
    if planes.dim() != 2 or planes.shape[0] != N_SYMBOLS:
        raise ValueError(
            f"planes must be ({N_SYMBOLS}, n_planes*H), got {tuple(planes.shape)}")
    if not 1 <= n_planes <= 4:
        raise ValueError(f"n_planes must be 1..4, got {n_planes}")
    if planes.shape[1] % n_planes or planes.shape[1] == 0:
        raise ValueError(f"{planes.shape[1]} plane columns do not hold "
                         f"{n_planes} planes")
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be {torch.uint8}, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    return planes.shape[1] // n_planes


def _check_lanes(a, h, dev):
    if a.dim() != 1:
        raise ValueError(f"a must be (B,), got {tuple(a.shape)}")
    for name, x in (("a", a), ("h", h)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the planes on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be {torch.int32}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.shape != a.shape:
        raise ValueError(f"h must be {tuple(a.shape)}, got {tuple(h.shape)}")


def hot_fetch_plain(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
                    n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """KF's function in torch ops, from the planes: masks and an index
    gather."""
    H = _check_planes(planes, n_planes)
    _check_lanes(a, h, planes.device)
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


def prepare_table(planes: torch.Tensor, n_planes: int = 3,
                  select: bool = True) -> torch.Tensor:
    """KF's table, on the planes' device: the planes interleaved,
    (256, W, 4) uint8, byte k of (a, h) being ``planes[a, k*H + h]`` for
    k < n_planes and 0 above, so that a lane's bytes are one aligned
    4-byte word; W = H with the select on, 1 with it off (column 0, all
    that function reads)."""
    H = _check_planes(planes, n_planes)
    W = H if select else 1
    table = torch.zeros((N_SYMBOLS, W, 4), dtype=torch.uint8,
                        device=planes.device)
    table[:, :, :n_planes] = planes.view(N_SYMBOLS, n_planes, H)[:, :, :W] \
        .transpose(1, 2)
    return table


class _FetchTable(ctypes.Structure):
    """``FetchTable`` of ``csrc/hot_fetch.cu``."""

    _fields_ = [("table", ctypes.c_void_p), ("W", ctypes.c_int32),
                ("n_planes", ctypes.c_int32), ("select", ctypes.c_int32),
                ("device", ctypes.c_int32)]


class HotFetch:
    """KF prepared for one set of planes ((256, n_planes*H) uint8, on
    the CPU or a CUDA device): ``HotFetch(planes, n_planes, select)(a,
    h)`` is the entry of each lane (``a``, ``h`` (B,) int32 on the
    planes' device), (B,) int32.  ``table`` is the prepared table
    (:func:`prepare_table`), ``words`` the same bytes as (256, W) int32
    words."""

    def __init__(self, planes: torch.Tensor, n_planes: int = 3,
                 select: bool = True):
        H = _check_planes(planes, n_planes)
        dev = planes.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"KF runs on CUDA devices, not {dev}")
        self.device, self.select, self.n_planes = dev, bool(select), n_planes
        self.table = prepare_table(planes, n_planes, select)
        self.words = self.table.view(torch.int32)[:, :, 0]
        self.W = self.table.shape[1]
        self._fn = None
        if dev.type == "cuda":
            # resolved once: the launch, the raw-stream query, the device
            # and the table's arguments, passed as one pointer
            self._fn = build.load(build.HOT_FETCH).dt_hot_fetch_launch
            self._stream = torch._C._cuda_getCurrentRawStream
            self._index = dev.index
            self._table = _FetchTable(self.table.data_ptr(), self.W,
                                      n_planes, self.select, dev.index)
            self._table_ptr = ctypes.c_void_p(ctypes.addressof(self._table))

    def plain(self, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The lane's work on the prepared table in torch ops."""
        _check_lanes(a, h, self.device)
        ok = (a > 0) & (a < N_SYMBOLS)
        idx, mask = a, 0xFF
        if self.select:
            ok &= (h >= 0) & (h < self.W)
            idx, mask = a * self.W + h, (1 << (8 * self.n_planes)) - 1
        word = self.words.reshape(-1)[torch.where(ok, idx, 0).long()]
        if mask < 1 << 31:  # (four planes keep the whole word)
            word = word & mask
        return torch.where(ok, word, 0)

    def __call__(self, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        fn = self._fn
        if fn is None:
            return self.plain(a, h)
        i32, idx = torch.int32, self._index
        # (get_device() is -1 off the card)
        if (a.get_device() != idx or h.get_device() != idx
                or a.dtype is not i32 or h.dtype is not i32 or a.dim() != 1
                or h.shape != a.shape or not a.is_contiguous()
                or not h.is_contiguous()):
            _check_lanes(a, h, self.device)
            raise ValueError("KF does not take these lanes")
        out = torch.empty_like(a)
        rc = fn(a.data_ptr(), h.data_ptr(), out.data_ptr(), a.shape[0],
                self._table_ptr, self._stream(idx))
        if rc != 0:
            raise RuntimeError(f"KF launch failed: CUDA error {rc}")
        hot_fetch.launches += 1
        return out

    def host(self, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """KF's lane body compiled for the host with g++ (tests only)."""
        if self.device.type != "cpu":
            raise ValueError("the host build takes CPU tensors")
        _check_lanes(a, h, self.device)
        out = torch.empty_like(a)
        build.load(build.MICRO_HOST).dt_hot_fetch_host(
            a.data_ptr(), h.data_ptr(), self.table.data_ptr(), self.W,
            self.n_planes, self.select, a.shape[0], out.data_ptr())
        return out


def hot_fetch(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
              n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """The entry of each lane (``a``, ``h`` (B,) int32; ``planes``
    (256, n_planes*H) uint8); returns (B,) int32.  Checks and prepares
    on every call; a loop of fetches on one table takes a
    :class:`HotFetch`."""
    _check_planes(planes, n_planes)
    _check_lanes(a, h, planes.device)
    if a.device.type == "cpu":
        return hot_fetch_plain(a, h, planes, n_planes, select)
    return HotFetch(planes, n_planes, select)(a, h)


hot_fetch.launches = 0


def hot_fetch_host(a: torch.Tensor, h: torch.Tensor, planes: torch.Tensor,
                   n_planes: int = 3, select: bool = True) -> torch.Tensor:
    """KF's lane body compiled for the host with g++, on the table
    prepared from ``planes`` (tests only)."""
    return HotFetch(planes, n_planes, select).host(a, h)
