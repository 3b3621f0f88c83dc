"""Fused pre-norm transformer FFN: K2f, K2b and K2r.

Counterpart of ``eavit_tpu/ops/fused_ffn.py``: ``fused_ffn`` (lines
389-425) computes ``drop2(fc2(drop1(gelu(fc1(LN(x))))))`` over the
flattened rows of ``x``. The math is the TPU kernel's (``_layernorm``
91-97, ``_erf`` 100-115, ``_recompute_fwd`` 128-157): LayerNorm in f32,
the LN output and both weight matrices rounded to the input dtype, f32
accumulation, exact GELU through the Abramowitz-Stegun erf, mask1 on the
hidden activations before mask2 on the output. The backward is
``_bwd_kernel`` (180-251): the forward recomputed, both masks regenerated,
``dx`` in x's dtype and the six parameter gradients in float32, with
``dy0``, ``gd`` and ``dh`` rounded to the input dtype where they enter a
product.

Dropout bits follow ``ops/kernel_prng.py``: Philox on the logical index of
each mask, ``r*hidden + j`` on stream 0 for mask1 and ``r*dim + c`` on
stream 1 for mask2. ``rate == 0`` draws nothing.

Weights use the torch layout: ``w1 [hidden, dim]`` and ``w2 [dim, hidden]``
(``nn.Linear``'s ``[out, in]``), all parameters float32 as in the modules.

Two versions of each function:

- :func:`fused_ffn_fwd_plain` / :func:`fused_ffn_bwd_plain` /
  :func:`fused_ffn_bits_plain`: plain torch;
- the CUDA kernels of ``csrc/fused_ffn.cu`` (K2f ``fused_ffn_fwd``, which
  replaces ``_fwd_kernel`` at fused_ffn.py:160 launched at line 288, and K2r
  ``fused_ffn_bits``, which replaces ``_masks_kernel`` at line 433 launched
  at line 455) and of ``csrc/fused_ffn_bwd.cu`` (K2b ``fused_ffn_bwd``, which
  replaces ``_bwd_kernel`` at line 180 launched at line 321). Both run their
  products on the tensor cores, a float32 operand as hi + lo bf16 planes.

K2f and K2b take every ``dim`` and every ``hidden``, as the JAX kernel takes
any width (fused_ffn.py:287-301). Where :func:`fused_widths`
says so (K2f at ``dim == 256``, K2b at ``dim % 32 == 0`` up to 256, both at
``hidden % 32 == 0``; every shipped config) they run their fused kernels,
which keep the hidden activations out of device memory; every other width
(the HF flavour's (1,024, 3,072) among them) runs the split path of
``csrc/ffn_wide.cuh``: row kernels and products on Hopper's ``wgmma`` fed by
TMA, whose epilogues apply the bias, GELU and the masks, so that the hidden
activations reach device memory only as the bf16 planes the next product
reads (:func:`split_scratch`), at widths padded to multiples of 32 with
zeros. It computes the same function with the same masks.

:func:`fused_ffn_fwd`, :func:`fused_ffn_bwd` and :func:`fused_ffn_bits` take
the plain version for a tensor on the CPU and launch the kernel for a CUDA
tensor; a CUDA tensor the kernel does not take (another dtype, not
contiguous) raises. :func:`fused_ffn` is differentiable
through one ``torch.autograd.Function`` whose backward is
:func:`fused_ffn_bwd`. ``launches`` counts wrapper calls that launched a
kernel (one per call; each C entry makes its several launches itself).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops.kernel_prng import dropout_args, keep_mask, raw_bits24

launches = {"fused_ffn_fwd": 0, "fused_ffn_bwd": 0, "fused_ffn_bits": 0}

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# row slices of K2b's weight-gradient kernel, whose 32 tiles of 128 x 128 (D =
# 256, Hd = 1024) then make 1,056 blocks, four rounds of two blocks on each of
# the 132 SMs of an H100 (tune_fused_ffn_bwd.py)
_BWD_SLICES = 33
_ROW_TILE = 64  # rows per block of K2b's dx kernel and of the split path's row kernels

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = _build.library("fused_ffn")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        tail = [ctypes.c_longlong, i, i, i, f, u, f, u, u, i, vp]
        lib.eavit_fused_ffn_fwd.argtypes = [vp] * 9 + tail
        lib.eavit_fused_ffn_fwd.restype = i
        lib.eavit_fused_ffn_fwd_wide.argtypes = [vp] * 11 + tail
        lib.eavit_fused_ffn_fwd_wide.restype = i
        lib.eavit_fused_ffn_fwd_smem.argtypes = [i, i]  # dim, dtype
        lib.eavit_fused_ffn_fwd_smem.restype = ctypes.c_size_t
        lib.eavit_fused_ffn_fwd_stage_bytes.argtypes = [i, i, i]  # dim, hidden, dtype
        lib.eavit_fused_ffn_fwd_stage_bytes.restype = ctypes.c_size_t
        lib.eavit_fused_ffn_bits.argtypes = [
            vp, ctypes.c_ulonglong, vp, ctypes.c_ulonglong, u, u, vp]
        lib.eavit_fused_ffn_bits.restype = i
        lib._eavit_typed = True
    return lib


def _bwd_lib():
    lib = _build.library("fused_ffn_bwd")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        tail = [ctypes.c_longlong, i, i, i, i, f, u, f, u, u, i, vp]
        lib.eavit_fused_ffn_bwd.argtypes = [vp] * 14 + tail
        lib.eavit_fused_ffn_bwd.restype = i
        # the split path takes no row slices
        lib.eavit_fused_ffn_bwd_wide.argtypes = [vp] * 15 + tail[:3] + tail[4:]
        lib.eavit_fused_ffn_bwd_wide.restype = i
        lib._eavit_typed = True
    return lib


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf, |error| <= 1.5e-7
    (eavit_tpu/ops/fused_ffn.py:100-115)."""
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    e = 1.0 - poly * torch.exp(-a * a)
    return torch.where(x < 0.0, -e, e)


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + erf_as(h * _INV_SQRT2))


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d gelu / dh with the same erf (eavit_tpu/ops/fused_ffn.py:122-125)."""
    phi = torch.exp(-0.5 * h * h) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + erf_as(h * _INV_SQRT2))
    return cdf + h * phi


def fused_ffn_fwd_plain(
    x2: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2, seeds=None, rate: float = 0.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain torch K2f on rows ``x2 [R, dim]`` -> ``[R, dim]`` in x's dtype."""
    dt = x2.dtype
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    u = (xc * rstd * ln_w.float() + ln_b.float()).to(dt).float()
    h = torch.matmul(u, w1.to(dt).float().t()) + b1.float()
    g = gelu_exact(h)
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    if thresh is not None:
        m1 = keep_mask(g.shape, seeds, 0, thresh, device=x2.device)
        g = torch.where(m1, g * inv_keep, torch.zeros_like(g))
    y = torch.matmul(g.to(dt).float(), w2.to(dt).float().t()) + b2.float()
    if thresh is not None:
        m2 = keep_mask(y.shape, seeds, 1, thresh, device=x2.device)
        y = torch.where(m2, y * inv_keep, torch.zeros_like(y))
    return y.to(dt)


def fused_widths(dim: int, hidden: int, forward: bool) -> bool:
    """Whether the fused kernel of K2f (``forward``) or of K2b takes these
    widths: K2f's is compiled for the dim of every shipped config, 256, K2b's
    takes any multiple of 32 up to 256. Every other width runs the split
    path (``csrc/ffn_wide.cuh``)."""
    return hidden % 32 == 0 and (dim == 256 if forward else dim % 32 == 0 and dim <= 256)


def _pad32(n: int) -> int:
    return (n + 31) // 32 * 32


def split_scratch(rows: int, dim: int, hidden: int, dtype: torch.dtype, forward: bool):
    """The scratch the split path's wrapper allocates, in the order its C entry
    takes it: ``[(name, shape, dtype)]``, at the widths padded to multiples
    of 32 (``Dp``, ``Hdp``) with ``P`` bf16 planes per operand (hi + lo for
    float32, one for bf16). The products keep their float32 sums in
    registers, so the hidden activations pass through device memory only as
    the bf16 planes the next product reads (gd, and dh in the backward): no
    float32 ``[rows, Hdp]`` buffer. The backward's float32 ``du [rows, Dp]``
    feeds the LayerNorm backward, which needs whole-row sums of it."""
    dp, hp = _pad32(dim), _pad32(hidden)
    planes = 2 if dtype == torch.float32 else 1
    bf, f32 = torch.bfloat16, torch.float32
    if forward:
        return [("wplanes", (2, planes, hp * dp), bf),  # W1 [Hdp][Dp], W2 [Dp][Hdp]
                ("u", (planes, rows, dp), bf),
                ("gd", (planes, rows, hp), bf)]
    tiles = (rows + _ROW_TILE - 1) // _ROW_TILE
    return [("grads", (2 * hp * dp + hp + 3 * dp,), f32),
            ("part_dx", (tiles, hp + 3 * dp), f32),  # db1, dln_w, dln_b, db2 by row tile
            ("wplanes", (3, planes, hp * dp), bf),  # W1, W2^T [Hdp][Dp]; W1^T [Dp][Hdp]
            ("rows", (2, planes, rows, dp), bf),  # u, dy0
            ("hidden", (2, planes, rows, hp), bf),  # dh, gd
            ("du", (rows, dp), f32),
            ("stats", (2, rows), f32)]  # mu, rstd


def fwd_smem_bytes(dim: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of one block of the fused K2f (``dim`` 256)."""
    return _lib().eavit_fused_ffn_fwd_smem(dim, _build.DTYPE_CODES[dtype])


def _check_kernel_args(what: str, x2, params) -> None:
    if x2.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x2.dtype} (float32 or bfloat16)")
    if not x2.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    w1 = params[2]
    rows, dim = x2.shape
    hidden = w1.shape[0]
    if rows < 1 or dim < 1 or hidden < 1:
        raise ValueError(f"{what}: empty input {tuple(x2.shape)}, hidden {hidden}")
    # the backward passes no b2: it enters no gradient
    shapes = (("ln_w", (dim,)), ("ln_b", (dim,)), ("w1", (hidden, dim)),
              ("b1", (hidden,)), ("w2", (dim, hidden)), ("b2", (dim,)))
    for (name, shape), t in zip(shapes, params):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x2.device:
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"on {x2.device}")


def fused_ffn_fwd(
    x2: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2, seeds=None, rate: float = 0.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K2f on rows ``x2 [R, dim]``; plain on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return fused_ffn_fwd_plain(x2, ln_w, ln_b, w1, b1, w2, b2, seeds, rate, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_ffn_fwd: unsupported device {x2.device}")
    params = (ln_w, ln_b, w1, b1, w2, b2)
    _check_kernel_args("fused_ffn_fwd", x2, params)
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    rows, dim = x2.shape
    hidden = w1.shape[0]
    y = torch.empty_like(x2)
    tail = (rows, dim, hidden, _build.DTYPE_CODES[x2.dtype], float(eps), thresh or 0,
            float(inv_keep), s0, s1, int(thresh is not None), _build.stream_ptr(x2))
    lib = _lib()
    if fused_widths(dim, hidden, forward=True):
        # every hidden chunk's W1 and W2 planes and b1, as one bulk copy moves them
        code = _build.DTYPE_CODES[x2.dtype]
        wplanes = torch.empty(lib.eavit_fused_ffn_fwd_stage_bytes(dim, hidden, code),
                              dtype=torch.uint8, device=x2.device)
        err = lib.eavit_fused_ffn_fwd(
            _build.ptr(x2), *(_build.ptr(p) for p in params), _build.ptr(y),
            _build.ptr(wplanes), *tail)
    else:
        scratch = [torch.empty(shape, dtype=dt, device=x2.device)
                   for _, shape, dt in split_scratch(rows, dim, hidden, x2.dtype, True)]
        err = lib.eavit_fused_ffn_fwd_wide(
            _build.ptr(x2), *(_build.ptr(p) for p in params), _build.ptr(y),
            *(_build.ptr(t) for t in scratch), *tail)
    _build.check(err, "fused_ffn_fwd")
    launches["fused_ffn_fwd"] += 1
    return y


def fused_ffn_bwd_plain(
    x2: torch.Tensor, ln_w, ln_b, w1, b1, w2, dy: torch.Tensor, seeds=None,
    rate: float = 0.0, eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """Plain torch K2b on rows: ``(dx, dln_w, dln_b, dw1, db1, dw2, db2)``,
    written as the explicit formulas of ``_bwd_kernel`` with both masks
    replayed. ``dx`` is in x's dtype, the parameter gradients float32."""
    dt = x2.dtype
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    u = (xhat * ln_w.float() + ln_b.float()).to(dt).float()
    w1d, w2d = w1.to(dt).float(), w2.to(dt).float()
    h = torch.matmul(u, w1d.t()) + b1.float()
    g = gelu_exact(h)
    dy0 = dy.float()
    if thresh is not None:
        m1 = keep_mask(g.shape, seeds, 0, thresh, device=x2.device)
        m2 = keep_mask(dy0.shape, seeds, 1, thresh, device=x2.device)
        g = torch.where(m1, g * inv_keep, torch.zeros_like(g))
        dy0 = torch.where(m2, dy0 * inv_keep, torch.zeros_like(dy0))
    gd = g.to(dt).float()
    dy0d = dy0.to(dt).float()
    dw2 = torch.matmul(dy0d.t(), gd)  # [dim, hidden]
    db2 = dy0.sum(dim=0)
    dg = torch.matmul(dy0d, w2d)
    if thresh is not None:
        dg = torch.where(m1, dg * inv_keep, torch.zeros_like(dg))
    dh = gelu_grad(h) * dg
    dhd = dh.to(dt).float()
    dw1 = torch.matmul(dhd.t(), u)  # [hidden, dim]
    db1 = dh.sum(dim=0)
    du = torch.matmul(dhd, w1d)
    dln_w = (du * xhat).sum(dim=0)
    dln_b = du.sum(dim=0)
    t = du * ln_w.float()
    dx = (t - t.mean(dim=-1, keepdim=True)
          - xhat * (t * xhat).mean(dim=-1, keepdim=True)) * rstd
    return dx.to(dt), dln_w, dln_b, dw1, db1, dw2, db2


def fused_ffn_bwd(
    x2: torch.Tensor, ln_w, ln_b, w1, b1, w2, dy: torch.Tensor, seeds=None,
    rate: float = 0.0, eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """K2b on rows: ``(dx, dln_w, dln_b, dw1, db1, dw2, db2)``; plain on the
    CPU, the kernel on CUDA. The parameter gradients are views of one flat
    buffer; every sum has a fixed order, so two calls give equal bits. The
    kernel's products run on the tensor cores from bf16 planes of their
    operands, two planes each (hi + lo) for float32 ``x``, one for bf16, in
    scratch the wrapper allocates (with dh and gd, 8 bytes per row and hidden
    unit in float32; the split path's is :func:`split_scratch`)."""
    if x2.device.type == "cpu":
        return fused_ffn_bwd_plain(x2, ln_w, ln_b, w1, b1, w2, dy, seeds, rate, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_ffn_bwd: unsupported device {x2.device}")
    _check_kernel_args("fused_ffn_bwd", x2, (ln_w, ln_b, w1, b1, w2))
    if (dy.shape != x2.shape or dy.dtype != x2.dtype or dy.device != x2.device
            or not dy.is_contiguous()):
        raise ValueError(f"fused_ffn_bwd: dy must be contiguous {x2.dtype} "
                         f"{tuple(x2.shape)} on {x2.device}")
    rows, dim = x2.shape
    hidden = w1.shape[0]
    fused = fused_widths(dim, hidden, forward=False)
    # the split path computes at widths padded to multiples of 32
    dp, hp = (dim, hidden) if fused else (_pad32(dim), _pad32(hidden))
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    dx = torch.empty_like(x2)
    args = (x2, ln_w, ln_b, w1, b1, w2, dy, dx)
    tail = (_build.DTYPE_CODES[x2.dtype], float(eps), thresh or 0, float(inv_keep), s0, s1,
            int(thresh is not None), _build.stream_ptr(x2))
    if fused:
        tiles = (rows + _ROW_TILE - 1) // _ROW_TILE
        slices = min(_BWD_SLICES, (rows + 31) // 32)  # no more slices than 32-row steps
        f32 = dict(dtype=torch.float32, device=x2.device)
        bf16 = dict(dtype=torch.bfloat16, device=x2.device)
        planes = 2 if x2.dtype == torch.float32 else 1  # hi + lo, or the rounded value
        grads = torch.empty(2 * hp * dp + hp + 3 * dp, **f32)
        scratch = (grads,
                   torch.empty((tiles, hp + 3 * dp), **f32),  # db1, dln_w, dln_b, db2
                   torch.empty((slices, 2 * hp * dp), **f32),  # dW1, dW2 by row slice
                   torch.empty((2, planes, hp * dp), **bf16),  # W1, W2
                   torch.empty((2, planes, rows, dp), **bf16),  # u, dy0
                   torch.empty((2, planes, rows, hp), **bf16))  # dh, gd
        err = _bwd_lib().eavit_fused_ffn_bwd(*(_build.ptr(t) for t in args + scratch),
                                             rows, dim, hidden, slices, *tail)
    else:
        scratch = [torch.empty(shape, dtype=dt, device=x2.device)
                   for _, shape, dt in split_scratch(rows, dim, hidden, x2.dtype, False)]
        grads = scratch[0]
        err = _bwd_lib().eavit_fused_ffn_bwd_wide(
            *(_build.ptr(t) for t in (*args, *scratch)), rows, dim, hidden, *tail)
    _build.check(err, "fused_ffn_bwd")
    launches["fused_ffn_bwd"] += 1
    dw1, dw2, db1, dln_w, dln_b, db2 = grads.split([hp * dp, dp * hp, hp, dp, dp, dp])
    dw1, dw2 = dw1.view(hp, dp), dw2.view(dp, hp)
    if not fused:  # the logical widths of the padded gradients
        dw1, dw2 = dw1[:hidden, :dim].contiguous(), dw2[:dim, :hidden].contiguous()
        db1, dln_w, dln_b, db2 = db1[:hidden], dln_w[:dim], dln_b[:dim], db2[:dim]
    return (dx, dln_w, dln_b, dw1, db1, dw2, db2)


class _FusedFFN(torch.autograd.Function):
    """K2f forward, K2b backward; the backward recomputes the forward from
    ``x2`` and the parameters, so no intermediate is saved."""

    @staticmethod
    def forward(ctx, x2, ln_w, ln_b, w1, b1, w2, b2, seeds, rate, eps):
        y = fused_ffn_fwd(x2, ln_w, ln_b, w1, b1, w2, b2, seeds, rate, eps)
        ctx.save_for_backward(x2, ln_w, ln_b, w1, b1, w2)
        ctx.args = (None if seeds is None else (int(seeds[0]), int(seeds[1])),
                    rate, eps)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if not any(ctx.needs_input_grad[:7]):
            return (None,) * 10
        x2, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        grads = fused_ffn_bwd(x2, ln_w, ln_b, w1, b1, w2, dy.contiguous(), *ctx.args)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad[:7])) + (None,) * 3


def fused_ffn(
    x: torch.Tensor,  # [..., dim]
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,  # [hidden, dim]
    b1: torch.Tensor,
    w2: torch.Tensor,  # [dim, hidden]
    b2: torch.Tensor,
    seeds=None,
    rate: float = 0.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``drop(fc2(drop(gelu(fc1(LN(x))))))`` (fused_ffn.py:389-425)."""
    if rate > 0.0 and seeds is None:
        raise ValueError("dropout rate > 0 requires seeds")
    lead, dim = x.shape[:-1], x.shape[-1]
    y = _FusedFFN.apply(x.reshape(-1, dim), ln_w, ln_b, w1, b1, w2, b2, seeds, rate, eps)
    return y.reshape(*lead, dim)


def fused_ffn_bits_plain(
    rows: int, dim: int, hidden: int, seeds, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2r: raw 24-bit values of (mask1 [rows, hidden], mask2 [rows, dim])."""
    m1 = raw_bits24(rows * hidden, seeds, 0, device).reshape(rows, hidden)
    m2 = raw_bits24(rows * dim, seeds, 1, device).reshape(rows, dim)
    return m1, m2


def fused_ffn_bits(
    rows: int, dim: int, hidden: int, seeds, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2r: replays both mask streams of the forward (counterpart of
    ``dropout_raw_bits``, fused_ffn.py:448). Plain on the CPU, the kernel
    on CUDA."""
    device = torch.device(device)
    if device.type == "cpu":
        return fused_ffn_bits_plain(rows, dim, hidden, seeds, device)
    if device.type != "cuda":
        raise ValueError(f"fused_ffn_bits: unsupported device {device}")
    m1 = torch.empty((rows, hidden), dtype=torch.int32, device=device)
    m2 = torch.empty((rows, dim), dtype=torch.int32, device=device)
    err = _lib().eavit_fused_ffn_bits(
        _build.ptr(m1), m1.numel(), _build.ptr(m2), m2.numel(),
        int(seeds[0]), int(seeds[1]), _build.stream_ptr(m1),
    )
    _build.check(err, "fused_ffn_bits")
    launches["fused_ffn_bits"] += 1
    return m1, m2
