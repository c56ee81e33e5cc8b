"""Packed XNOR-popcount GEMM: (M, Kw) packed inputs x (N, Kw) packed
weights -> (M, N), the paper's Eq. (2) over 32-bit words.

Both operands arrive packed (``binarize_pack``, -1.0 padding, so pad
bits are 0 in both); ``s`` is the true contraction length in bits and
the pad correction is ``Kw*32 - s`` for the word count Kw passed.
Modes as ``ref.epilogue``: bitcount, dot, dot_scaled, binary_act.
``core/conv.bnn_conv2d`` runs every binarized conv layer through it.

``xnor_popcount_matmul`` is the wrapper: on a CUDA tensor it launches
the hand-written kernel (csrc/xnor_popcount.cu) or raises; on a CPU
tensor it computes ``xnor_popcount_matmul_torch``, the plain version.
``xnor_plan`` chooses the kernel's route, tile width and K split from
the shape and the card's SM count; the kernel takes the plan as ints.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import _lib, ref

KERNEL = _lib.KernelInfo(
    "xnor_popcount", "src/repro_torch/csrc/xnor_popcount.cu",
    "src/repro/kernels/xnor_popcount.py:97")

ROUTE_READ, ROUTE_TILE, ROUTE_MMA = 0, 1, 2   # csrc/xnor_popcount.cu
SMALL_M = 8              # rows the weight-read route takes (bnn_gemm.cuh)
MMA_STEP_WORDS = 8       # K of one binary mma step; shallower K takes
                         # the CUDA-core tile route
TILE_M = 64              # rows of a tensor-core tile
MIN_PART_WORDS = 32      # the shortest K part a split gives a block
SMALL_SMEM = 48 * 1024   # the CUDA-core route stages M x Kw words
_counters: dict[torch.device, torch.Tensor] = {}

_OUT_DTYPE = {"bitcount": torch.int32, "dot": torch.int32,
              "dot_scaled": torch.float32, "binary_act": torch.uint8}


def xnor_popcount_matmul_torch(ip: torch.Tensor, wp: torch.Tensor, s: int,
                               *, mode: str = "dot",
                               alpha: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version (``alpha`` defaults to ones, as in the Pallas
    wrapper)."""
    if alpha is None:
        alpha = torch.ones(wp.shape[0], dtype=torch.float32, device=wp.device)
    return ref.xnor_popcount_matmul_ref(ip, wp, s, mode, alpha)


def xnor_plan(m: int, n: int, kw: int, sm_count: int
              ) -> tuple[int, int, int, int]:
    """The kernel's launch plan ``(route, bn, parts, part_words)``:

    * M <= 8 (and its packed rows fit the block's shared memory): a read
      of the packed weight on CUDA cores, ``(ROUTE_READ, 0, 1, kw)``;
    * K under one binary mma step (Kw < 8): 64 x 64 CUDA-core tiles,
      ``(ROUTE_TILE, 0, 1, kw)``;
    * else binary-mma tiles of 64 x bn, bn = 64 where 64-wide tiles fill
      the card's ``sm_count`` SMs and 32 otherwise; where the tiles
      still leave SMs idle, K is split into ``parts`` runs of
      ``part_words`` words (a multiple of 8, at least MIN_PART_WORDS),
      enough for one wave, or as many as K allows; no part is empty.
    """
    if m <= SMALL_M and m * kw * 4 <= SMALL_SMEM:
        return ROUTE_READ, 0, 1, kw
    if kw < MMA_STEP_WORDS:
        return ROUTE_TILE, 0, 1, kw
    mt = -(-m // TILE_M)
    bn = 64 if mt * -(-n // 64) >= sm_count else 32
    tiles = mt * -(-n // bn)
    want = -(-sm_count // tiles)
    k8, min8 = -(-kw // 8), MIN_PART_WORDS // 8
    if want <= 1 or k8 < 2 * min8:
        return ROUTE_MMA, bn, 1, kw
    # a split grid is under one wave, so its tiles are 32 wide; want >= 2
    # and k8 >= 2 min8 give at least two parts
    per8 = max(min8, k8 // want)
    return ROUTE_MMA, bn, -(-k8 // per8), 8 * per8


def _tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """Split K's per-tile counters on ``device``: zeroed once, for as
    many tiles as the card has SMs (a plan splits only grids of fewer
    tiles), and left at zero by every launch (the last block of a tile
    resets its counter).  Launches that share them run in order on one
    stream."""
    sms = _lib.sm_count(device)
    if tiles > sms:
        raise ValueError(f"xnor_popcount_matmul: {tiles} split tiles on a "
                         f"card of {sms} SMs")
    if device not in _counters:
        _counters[device] = torch.zeros(sms, dtype=torch.int32,
                                        device=device)
    return _counters[device]


def xnor_popcount_matmul(ip: torch.Tensor, wp: torch.Tensor, s: int, *,
                         mode: str = "dot",
                         alpha: torch.Tensor | None = None) -> torch.Tensor:
    """unpack(ip) . unpack(wp).T over ``s`` bits, in the mode's output
    type."""
    if ip.device.type == "cpu":
        return xnor_popcount_matmul_torch(ip, wp, s, mode=mode, alpha=alpha)
    if ip.device.type != "cuda":
        raise ValueError(f"xnor_popcount_matmul: no kernel for device "
                         f"{ip.device}")
    if mode not in _OUT_DTYPE:
        raise ValueError(f"unknown mode {mode!r}")
    if ip.ndim != 2 or wp.ndim != 2 or ip.shape[1] != wp.shape[1]:
        raise ValueError(f"xnor_popcount_matmul: ip {tuple(ip.shape)} and "
                         f"wp {tuple(wp.shape)} are not (M, Kw), (N, Kw)")
    m, kw = ip.shape
    n = wp.shape[0]
    if not 0 < s <= kw * packing.WORD_BITS:
        raise ValueError(f"xnor_popcount_matmul: {kw} words cannot hold s={s}")
    _lib.check(ip, "ip", torch.int32, (m, kw), ip.device)
    _lib.check(wp, "wp", torch.int32, (n, kw), ip.device)
    alpha_ptr = None            # the kernel reads alpha only in dot_scaled
    if mode == "dot_scaled":
        if alpha is None:
            alpha = torch.ones(n, dtype=torch.float32, device=ip.device)
        _lib.check(alpha, "alpha", torch.float32, (n,), ip.device)
        alpha_ptr = _lib.ptr(alpha)
    out = torch.empty((m, n), dtype=_OUT_DTYPE[mode], device=ip.device)
    route, bn, parts, part_words = xnor_plan(m, n, kw,
                                             _lib.sm_count(ip.device))
    part_ptr = counters = None
    if parts > 1:              # each part's tiles of mismatch counts
        tiles = -(-m // TILE_M) * -(-n // bn)
        counters = _lib.ptr(_tile_counters(ip.device, tiles))
        part = torch.empty((parts, tiles, TILE_M * bn), dtype=torch.int32,
                           device=ip.device)
        part_ptr = _lib.ptr(part)
    _lib.launch("xp_xnor_popcount", ip.device, _lib.ptr(ip), _lib.ptr(wp),
                alpha_ptr, _lib.ptr(out), part_ptr, counters, m, n, s, kw,
                route, bn, parts, part_words, ref.MODES.index(mode))
    KERNEL.launches += 1
    return out
