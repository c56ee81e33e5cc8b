"""Bitpacking: {0,1} bit tensors <-> packed 32-bit words along the
reduction axis.

Packing layout (identical to the JAX package): the reduction axis (last
axis by convention) is padded to a multiple of 32 and packed
little-endian — bit j of word k holds element ``32*k + j``.  Padding
bits are zero in BOTH operands; because XNOR(0,0)=1 would corrupt the
bitcount, the popcount path subtracts the pad correction (see xnor.py).

Words are stored as **int32** tensors: the same 32 bits as the JAX
package's uint32 words (``np.view`` converts between the two at the
interop boundary).  PyTorch on the CPU implements no uint32 shifts,
add, sub or ``~``, so everything here runs on int32 or int64, and every
right shift of an int32 is masked, because int32 ``>>`` is arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WORD_BITS = 32


def packed_len(s: int) -> int:
    return (s + WORD_BITS - 1) // WORD_BITS


def pad_to_word(x01: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad the given axis of a {0,1} tensor to a multiple of 32."""
    axis = axis if axis >= 0 else x01.ndim + axis
    pad = (-x01.shape[axis]) % WORD_BITS
    if pad == 0:
        return x01
    widths = [0, 0] * (x01.ndim - axis - 1) + [0, pad]
    return F.pad(x01, widths)


def pack_bits(x01: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {0,1} tensor into int32 words along ``axis``.

    Shape: (..., S, ...) -> (..., ceil(S/32), ...).
    """
    axis = axis if axis >= 0 else x01.ndim + axis
    x01 = pad_to_word(x01.to(torch.int64), axis)
    s_pad = x01.shape[axis]
    new_shape = (x01.shape[:axis] + (s_pad // WORD_BITS, WORD_BITS)
                 + x01.shape[axis + 1:])
    xw = x01.reshape(new_shape)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=x01.device)
    shifts = shifts.reshape((1,) * (axis + 1) + (WORD_BITS,)
                            + (1,) * (x01.ndim - axis - 1))
    # distinct bits never carry, so the sum is the bitwise OR; computed
    # in int64 and reinterpreted as the word's two's-complement int32
    words = torch.sum(xw << shifts, dim=axis + 1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_bits(xw: torch.Tensor, s: int, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_bits: int32 words -> {0,1} uint8 tensor of length s."""
    axis = axis if axis >= 0 else xw.ndim + axis
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=xw.device)
    shifts = shifts.reshape((1,) * (axis + 1) + (WORD_BITS,)
                            + (1,) * (xw.ndim - axis - 1))
    bits = (xw.unsqueeze(axis + 1) >> shifts) & 1      # masked shift
    new_shape = xw.shape[:axis] + (xw.shape[axis] * WORD_BITS,) \
        + xw.shape[axis + 1:]
    return bits.reshape(new_shape).narrow(axis, 0, s).to(torch.uint8)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Population count of each 32-bit word (SWAR bit-twiddle), int32.

    The word is widened to its unsigned value in int64 first, so no
    step overflows or sign-extends.
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def pack_pm1(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {-1,+1} (or real, sign-taken) tensor: bit=1 iff x>=0."""
    return pack_bits(x >= 0, axis=axis)
