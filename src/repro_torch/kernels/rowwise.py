"""Row-wise float32 ops whose every output row has one fixed order of
rounding: the GEMM ``row_gemm`` (the LM head, the MoE router) and the
norm ``row_norm`` (RMSNorm, LayerNorm).

A library GEMM or row reduction picks its algorithm, and with it the
order of a row's sums, by the shapes around the row: cuBLAS rounded
mixtral-8x7b's head over half the vocab 8.1e-6 away from the whole
head, and ATen summed a 2048-wide row in another order at 4 rows than
at 8 (NVIDIA H100, ``chip_ranks_full.py --rows``).  Over a (data,
model) mesh a rank runs its own rows against its own vocab slice, so
these ops fix the order instead (``csrc/row_gemm.cu``,
``csrc/row_norm.cu``): a row's bits depend on the row (and a column of
w) alone, and the ranks' results are one rank's.  Each order is set by
K or D alone, so the kernels may split a row's work wherever the order
allows it (the routers over K, a wide row over a block's warps).

Beside each kernel its plain version repeats the kernel's order with
torch ops, one correctly rounded float32 op at a time, so on the card
the two are equal bit for bit, and on the CPU a row's bits are the
same at any M too:

* ``row_gemm_torch``: K in chunks of ``KC`` = 256; each chunk's
  partial ``p = p + x[:, k, None] * w[k]`` over its k ascending from
  zeros, every chunk at once in an (M, C, N) accumulator (KC small ops,
  or K where K <= KC: 64 at the reduced configs' d_model); then
  ``y = 0 + p_0 + p_1 + ...`` in ascending chunk order.  For K <= KC
  that is the one chain over k the kernel had before it split K;
* ``row_norm_torch``: a row has 32 W lanes, W = ``warps(D)`` =
  min(8, ceil(D / 1024)); lane l sums its 4-element chunks ``c = l,
  l + 32 W, ...`` in order, each warp's 32 lanes an xor butterfly, the
  W warp totals in ascending order (for D <= 1024 the one warp of the
  kernel before wider rows got a block); ``1 / sqrt`` (both correctly
  rounded: ``rsqrt`` on the card is not), and the divisions by D over a
  tensor of D's, not a scalar (ATen multiplies a CUDA tensor by a
  scalar's reciprocal instead).

Neither uses a fused multiply-add: torch repeats a float32 FMA only
through a float64 product, TwoSum and round to odd, many times the
cost of the separate ops on the CPU at the reduced configs' shapes,
and this plain version runs in every CPU forward.  Nor the tensor
cores: their float32 sums truncate, and no plain version could repeat
their order.

On a ``meta`` tensor (the dry-run: shapes, no values) each makes its
output alone, as the kernel's wrapper allocates it.  The gradients are
``torch.autograd.Function``s whose backward is torch ops: dx = dy wᵀ,
dw = xᵀ dy; the norm's is autograd of the library formula recomputed
from the saved input.  ``kernels/ops.row_gemm`` / ``row_norm`` dispatch
by the tensor's device (``ops.resolve_impl``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib

KERNEL_GEMM = _lib.KernelInfo(
    "row_gemm", "src/repro_torch/csrc/row_gemm.cu",
    "src/repro/models/transformer.py:295; src/repro/layers/moe.py:80")
KERNEL_NORM = _lib.KernelInfo(
    "row_norm", "src/repro_torch/csrc/row_norm.cu",
    "src/repro/layers/common.py:140-157")

KC = 256              # row_gemm: the K-chunk of the order
LANES = 32            # row_norm: a warp's lanes
CHUNK = 4             # consecutive elements a lane takes in turn
LANE_SPAN = 1024      # elements a warp of a row covers ...
MAX_WARPS = 8         # ... up to this many warps a row


def warps(d: int) -> int:
    """The warps a row of width d is summed over: min(8, ceil(d / 1024))
    (``csrc/row_norm.cu`` ``warps``)."""
    return min(MAX_WARPS, -(-d // LANE_SPAN))

# ----------------------------------------------------------------- row_gemm


def row_gemm_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (M, K) @ w (K, N) in float32 in the kernel's order:
    each KC-chunk's partial over its k ascending from +0.0, then the
    partials added in ascending chunk order from +0.0; each product and
    each add rounded."""
    m, k = x.shape
    n = w.shape[1]
    if x.device.type == "meta":
        return x.new_empty((m, n), dtype=torch.float32)
    x, w = x.float(), w.float()
    chunks = -(-k // KC)
    steps = KC if chunks > 1 else k
    pad = chunks * steps - k
    if pad:     # zeros add +-0.0 to a partial that is never -0.0
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.cat([w, w.new_zeros((pad, n))])
    xc = x.reshape(m, chunks, steps)
    wc = w.reshape(chunks, steps, n)
    part = torch.zeros((m, chunks, n), dtype=torch.float32, device=x.device)
    for i in range(steps):
        part.add_(torch.mul(xc[:, :, i, None], wc[:, i]))
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for c in range(chunks):
        out.add_(part[:, c])
    return out


def row_gemm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/row_gemm.cu``): x (M, K) float32 contiguous, w
    (K, N) float32 of any strides (the tied head's transposed view is
    read as it is)."""
    if x.device.type != "cuda":
        raise ValueError(f"row_gemm: no kernel for device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"row_gemm: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    _lib.check(x, "x", torch.float32, (m, k), x.device)
    if w.device != x.device or w.dtype != torch.float32:
        raise ValueError(f"row_gemm: w {w.dtype} on {w.device}, expected "
                         f"float32 on {x.device}")
    if max(w.stride()) >= 2 ** 31 or min(w.stride()) < 0:
        raise ValueError(f"row_gemm: w strides {w.stride()}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _lib.launch("rg_row_gemm", x.device, _lib.ptr(x), _lib.ptr(w),
                _lib.ptr(out), m, n, k, w.stride(0), w.stride(1))
    KERNEL_GEMM.launches += 1
    return out


class _RowGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fn):
        ctx.save_for_backward(x, w)
        return fn(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = torch.matmul(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def row_gemm(x: torch.Tensor, w: torch.Tensor, cuda: bool) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) float32 in the fixed order, by
    the kernel (``cuda``) or the plain version; differentiable."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    fn = row_gemm_cuda if cuda else row_gemm_torch
    if cuda:
        x2 = x2.contiguous()
    w = w.float()
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _RowGemm.apply(x2, w, fn)
    else:
        y = fn(x2, w)
    return y.reshape(*lead, w.shape[1])


# ----------------------------------------------------------------- row_norm


def _lane_sums(v: torch.Tensor) -> torch.Tensor:
    """(M, D) -> (M, 1): the kernel's order of a row's sum (module
    docstring): the 32 W lanes' sums over their chunks in turn, each
    warp's butterfly, then the warp totals in ascending order."""
    m, d = v.shape
    nw = warps(d)
    width = nw * LANES * CHUNK
    pad = (-d) % width
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(m, -1, nw * LANES, CHUNK)
    acc = torch.zeros((m, nw * LANES), dtype=torch.float32, device=v.device)
    for j in range(v.shape[1]):
        for e in range(CHUNK):
            acc = acc + v[:, j, :, e]
    acc = acc.reshape(m, nw, LANES)
    lanes = torch.arange(LANES, device=v.device)
    o = LANES // 2
    while o:
        acc = acc + acc[:, :, lanes ^ o]
        o //= 2
    if nw == 1:
        return acc[:, 0, :1]
    total = torch.zeros((m, 1), dtype=torch.float32, device=v.device)
    for w in range(nw):
        total = total + acc[:, w, :1]
    return total


def _over(s: torch.Tensor, d: int) -> torch.Tensor:
    """s / d, a true division (over a tensor of d's, not a scalar)."""
    return torch.div(s, torch.full_like(s, float(d)))


def row_norm_torch(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None, eps: float,
                   layer: bool) -> torch.Tensor:
    """Plain version: the norm of x (M, D) float32 in the kernel's
    order (RMSNorm, or LayerNorm with ``layer``)."""
    if x.device.type == "meta":
        return x.new_empty(x.shape, dtype=torch.float32)
    x = x.float()
    d = x.shape[-1]
    if layer:
        mu = _over(_lane_sums(x), d)
        xc = x - mu
        var = _over(_lane_sums(xc * xc), d)
    else:
        xc = x
        var = _over(_lane_sums(x * x), d)
    r = torch.reciprocal(torch.sqrt(var + eps))
    y = (xc * r) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


def row_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor | None, eps: float,
                  layer: bool) -> torch.Tensor:
    """The kernel (``csrc/row_norm.cu``): x (M, D), scale and bias (D),
    float32 contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"row_norm: no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"row_norm: x {tuple(x.shape)} is not (M, D)")
    m, d = x.shape
    _lib.check(x, "x", torch.float32, (m, d), x.device)
    _lib.check(scale, "scale", torch.float32, (d,), x.device)
    if bias is not None:
        _lib.check(bias, "bias", torch.float32, (d,), x.device)
    out = torch.empty((m, d), dtype=torch.float32, device=x.device)
    _lib.launch("rn_row_norm", x.device, _lib.ptr(x), _lib.ptr(scale),
                ctypes.c_void_p(None if bias is None else bias.data_ptr()),
                _lib.ptr(out), m, d, float(eps), int(layer))
    KERNEL_NORM.launches += 1
    return out


def _library_norm(x, scale, bias, eps: float, layer: bool) -> torch.Tensor:
    """The norm written as the JAX package writes it (library mean and
    rsqrt): ``row_norm``'s gradient is autograd of this."""
    if layer:
        mu = torch.mean(x, dim=-1, keepdim=True)
        xc = x - mu
        var = torch.mean(xc * xc, dim=-1, keepdim=True)
    else:
        xc = x
        var = torch.mean(x * x, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale
    return y + bias if bias is not None else y


class _RowNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, layer, fn):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.layer = eps, layer
        return fn(x, scale, bias, eps, layer)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        want = [t is not None and n for t, n in
                zip((x, scale, bias), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip((x, scale, bias), want)]
            y = _library_norm(*ins, ctx.eps, ctx.layer)
            grads = torch.autograd.grad(
                y, [t for t, w in zip(ins, want) if w], dy)
        it = iter(grads)
        return (*(next(it) if w else None for w in want), None, None, None)


def row_norm(x: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None, eps: float, layer: bool,
             cuda: bool) -> torch.Tensor:
    """The norm of x (..., D) over its last dim, float32, in the fixed
    order, by the kernel (``cuda``) or the plain version;
    differentiable."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).float()
    scale = scale.float()
    bias = None if bias is None else bias.float()
    fn = row_norm_torch
    if cuda:
        fn = row_norm_cuda
        x2, scale = x2.contiguous(), scale.contiguous()
        bias = None if bias is None else bias.contiguous()
    args = (x2, scale, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        y = _RowNorm.apply(x2, scale, bias, eps, layer, fn)
    else:
        y = fn(x2, scale, bias, eps, layer)
    return y.reshape(shape)
