"""Attention straight from the raw qkv projection: K1f, K1b and K1r.

Counterpart of ``eavit_tpu/ops/flash_qkv.py``: ``flash_mha_qkv`` (lines
638-675) computes ``dropout(softmax(q k^T * scale)) v`` per head from the
``[B, N, 3*H*Dh]`` output of the qkv Dense and returns ``[B, N, H*Dh]``,
with the head split and merge inside the kernel. The math is the TPU
kernel's (``_masked_scores`` 199-212, ``_head_fwd`` 223-239): f32 scores,
the dual-query mask when ``num_special > 0`` (``ops/attention.py``),
softmax, probability dropout on the normalised sigma, sigma rounded to the
input dtype, then ``sigma v`` with f32 accumulation. The forward also
returns the row log-sum-exp ``[B, H, N]`` that the backward needs. The
backward is ``_head_bwd`` (266-302): from ``qkv``, ``lse`` and ``dO`` it
regenerates the mask, recomputes sigma and returns one merged ``dqkv``; its
two roundings to the input dtype (of the dropped probabilities before
``dv`` and of ``ds`` before ``dq`` / ``dk``) are part of the function.

Dropout bits follow ``ops/kernel_prng.py``: Philox on the logical index
``((b*H + h)*N + i)*N + j`` of the ``[B, H, N, N]`` mask, stream 0, keyed by
two seed words per call. ``rate == 0`` draws nothing.

Two versions of each function:

- :func:`flash_qkv_fwd_plain` / :func:`flash_qkv_bwd_plain` /
  :func:`flash_qkv_bits_plain`: plain torch, the oracle;
- the CUDA kernels of ``csrc/flash_qkv.cu`` (K1f ``flash_qkv_fwd``, which
  replaces ``_fwd_kernel`` at flash_qkv.py:242 launched at line 531, and K1r
  ``flash_qkv_bits``, which replaces ``_bits_kernel`` at line 683 launched
  at line 715) and of ``csrc/flash_qkv_bwd.cu`` (K1b ``flash_qkv_bwd``,
  which replaces ``_bwd_kernel`` at line 305 launched at line 580). bf16
  inputs run on the tensor cores (``csrc/attn_fwd_mma.cuh`` for K1f,
  ``csrc/attn_bwd_mma.cuh`` for K1b), float32 inputs on the CUDA cores
  (``csrc/flash_stream.cuh``). Every one streams K and V (and the backward
  Q and dO) through shared memory in tiles of a fixed size, so each takes
  any N, as ``flash_mha_qkv`` does (its XLA path past ``supports(n)``,
  lines 185-192 and 660-665, computes the same function);
  :func:`fwd_smem` and :func:`bwd_smem` report the bytes, which depend on
  ``Dh`` and the dtype only.

:func:`flash_qkv_fwd`, :func:`flash_qkv_bwd` and :func:`flash_qkv_bits` take
the plain version for a tensor on the CPU and launch the kernel for a CUDA
tensor; a CUDA tensor the kernel does not take (another dtype or layout,
``Dh`` above 128, bf16 not on a 16-byte boundary) raises before any launch.
The kernels are instantiated at ``Dh`` 16, 32, 64 and 128 (the whole-head
ones up to 64); a head of another width up to 128 runs at the next of them:
the merged layout is viewed as
``[B, N, 3, H, Dh]``, each head zero-padded and merged back, and the
outputs sliced the same way (``_build.pad_heads``), which is exact. :func:`flash_mha_qkv` is differentiable through one
``torch.autograd.Function`` whose backward is :func:`flash_qkv_bwd`.

K1f and K1b each have two bf16 kernels: where a head fits in one block's
shared memory and N <= 256 (``_build.HEAD_MAX_N``) the wrapper runs the
whole-head forms (``csrc/attn_fwd_head.cuh``,
``csrc/attn_bwd_head.cuh``; the faster ones at the flagship N = 198), past
that the streaming ones (:func:`fwd_kernel` / :func:`bwd_kernel` say which;
``kernel="head"`` / ``"stream"`` takes one). ``launches`` counts wrapper
calls that launched a kernel, each kernel under its own key
(``flash_qkv_fwd`` / ``flash_qkv_bwd`` the whole-head kernels,
``flash_qkv_fwd_stream`` / ``flash_qkv_bwd_stream`` the streaming ones; the
streaming K1b is two CUDA launches, a dq pass and a dk/dv pass, counted
once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops.attention import dual_query_allowed
from eavit_tpu_torch.ops.kernel_prng import dropout_args, keep_mask, raw_bits24

# wrapper calls that launched each kernel since the last reset (chip_smoke.py
# reads them)
launches = {"flash_qkv_fwd": 0, "flash_qkv_fwd_stream": 0, "flash_qkv_bwd": 0,
            "flash_qkv_bwd_stream": 0, "flash_qkv_bits": 0}



def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bwd_lib():
    lib = _build.library("flash_qkv_bwd")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.eavit_flash_qkv_bwd.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, f, i, u, f, u, u, i, vp]
        lib.eavit_flash_qkv_bwd.restype = i
        lib.eavit_flash_qkv_bwd_head.argtypes = [
            vp, vp, vp, vp, i, i, i, i, f, i, u, f, u, u, i, vp]
        lib.eavit_flash_qkv_bwd_head.restype = i
        lib.eavit_flash_qkv_bwd_smem.argtypes = [i, i, i]  # Dh, dtype, pass
        lib.eavit_flash_qkv_bwd_head_smem.argtypes = [i, i]  # N, Dh
        for name in ("eavit_flash_qkv_bwd_smem", "eavit_flash_qkv_bwd_head_smem"):
            getattr(lib, name).restype = ctypes.c_size_t
        lib._eavit_typed = True
    return lib


def _lib():
    lib = _build.library("flash_qkv")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.eavit_flash_qkv_fwd.argtypes = [
            vp, vp, vp, i, i, i, i, i, f, i, u, f, u, u, i, vp]
        lib.eavit_flash_qkv_fwd.restype = i
        lib.eavit_flash_qkv_fwd_head.argtypes = [vp, vp, vp, i, i, i, i, f, i, u, f, u, u, i, vp]
        lib.eavit_flash_qkv_fwd_head.restype = i
        lib.eavit_flash_qkv_fwd_smem.argtypes = [i, i]  # Dh, dtype
        lib.eavit_flash_qkv_fwd_head_smem.argtypes = [i, i]  # N, Dh
        for name in ("eavit_flash_qkv_fwd_smem", "eavit_flash_qkv_fwd_head_smem"):
            getattr(lib, name).restype = ctypes.c_size_t
        lib.eavit_flash_qkv_bits.argtypes = [vp, ctypes.c_ulonglong, u, u, vp]
        lib.eavit_flash_qkv_bits.restype = i
        lib._eavit_typed = True
    return lib


def fwd_smem(dim_head: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of one K1f block; N does not enter."""
    width = _build.kernel_dim_head("fwd_smem", dim_head)
    return _lib().eavit_flash_qkv_fwd_smem(width, _build.DTYPE_CODES[dtype])


def bwd_smem(dim_head: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Bytes of shared memory of one block of K1b's dq and dk/dv passes; N
    does not enter."""
    code = _build.DTYPE_CODES[dtype]
    width = _build.kernel_dim_head("bwd_smem", dim_head)
    return tuple(_bwd_lib().eavit_flash_qkv_bwd_smem(width, code, w) for w in (0, 1))


def head_fits(which: str, n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """Whether the whole-head bf16 kernel of K1f (``"fwd"``) or K1b
    (``"bwd"``) holds a head of ``n`` tokens in one block's shared memory."""
    width = _build.kernel_dim_head("head_fits", dim_head)
    if dtype != torch.bfloat16 or width > _build.HEAD_MAX_DIM_HEAD:
        return False
    smem = (_lib().eavit_flash_qkv_fwd_head_smem if which == "fwd"
            else _bwd_lib().eavit_flash_qkv_bwd_head_smem)
    return smem(n, width) <= _build.SMEM_LIMIT


def fwd_kernel(n: int, dim_head: int, dtype: torch.dtype) -> str:
    """The ``launches`` key of the kernel a CUDA K1f call runs: the whole-head
    bf16 kernel where a head fits and N <= ``_build.HEAD_MAX_N``, else the
    streaming one."""
    head = n <= _build.HEAD_MAX_N and head_fits("fwd", n, dim_head, dtype)
    return "flash_qkv_fwd" if head else "flash_qkv_fwd_stream"


def bwd_kernel(n: int, dim_head: int, dtype: torch.dtype) -> str:
    """The ``launches`` key of the kernel a CUDA K1b call runs (as
    :func:`fwd_kernel`)."""
    head = n <= _build.HEAD_MAX_N and head_fits("bwd", n, dim_head, dtype)
    return "flash_qkv_bwd" if head else "flash_qkv_bwd_stream"


def flash_qkv_fwd_plain(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
    num_special: int = 0, seeds=None, rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K1f: returns ``(o [B, N, H*Dh], lse [B, H, N])``."""
    b, n, _ = qkv.shape
    inner = heads * dim_head
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    q, k, v = (
        t.reshape(b, n, heads, dim_head).permute(0, 2, 1, 3)
        for t in qkv.float().split(inner, dim=-1)
    )
    s = torch.matmul(q, k.transpose(-1, -2)) * scale  # f32 [B, H, N, N]
    if num_special:
        allowed = dual_query_allowed(n, n, num_special, device=qkv.device)
        s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    sigma = p / l
    if thresh is not None:
        keep = keep_mask((b, heads, n, n), seeds, 0, thresh, device=qkv.device)
        sigma = torch.where(keep, sigma * inv_keep, torch.zeros_like(sigma))
    o = torch.matmul(sigma.to(qkv.dtype).float(), v)
    o = o.permute(0, 2, 1, 3).reshape(b, n, inner).to(qkv.dtype)
    return o, (m + torch.log(l))[..., 0]


def _check_kernel_args(what: str, qkv: torch.Tensor, heads: int, dim_head: int) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    if qkv.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {qkv.dtype} (float32 or bfloat16)")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(f"{what}: qkv shape {tuple(qkv.shape)} is not "
                         f"[B, N, 3*{heads}*{dim_head}]")
    _build.kernel_dim_head(what, dim_head)
    if not qkv.is_contiguous():
        raise ValueError(f"{what}: qkv must be contiguous")


def flash_qkv_fwd(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float,
    num_special: int = 0, seeds=None, rate: float = 0.0, kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1f: ``(o, lse)``; plain version on the CPU, a kernel on CUDA (the
    whole-head or the streaming one, :func:`fwd_kernel`; ``kernel`` =
    ``"head"`` or ``"stream"`` takes one)."""
    if qkv.device.type == "cpu":
        return flash_qkv_fwd_plain(qkv, heads, dim_head, scale, num_special, seeds, rate)
    _check_kernel_args("flash_qkv_fwd", qkv, heads, dim_head)
    b, n, _ = qkv.shape
    logical, dim_head = dim_head, _build.kernel_dim_head("flash_qkv_fwd", dim_head)
    qkv = _build.pad_heads(qkv, 3 * heads, dim_head)
    if qkv.dtype == torch.bfloat16:
        _build.check_aligned("flash_qkv_fwd", qkv)
    lib = _lib()
    head = _build.whole_head("flash_qkv_fwd", kernel, head_fits("fwd", n, dim_head, qkv.dtype),
                             fwd_kernel(n, dim_head, qkv.dtype) == "flash_qkv_fwd")
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    o = torch.empty((b, n, heads * dim_head), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    common = (float(scale), int(num_special), thresh or 0, float(inv_keep), s0, s1,
              int(thresh is not None), _build.stream_ptr(qkv))
    if head:
        err = lib.eavit_flash_qkv_fwd_head(_build.ptr(qkv), _build.ptr(o), _build.ptr(lse),
                                           b, n, heads, dim_head, *common)
    else:
        err = lib.eavit_flash_qkv_fwd(_build.ptr(qkv), _build.ptr(o), _build.ptr(lse), b, n,
                                      heads, dim_head, _build.DTYPE_CODES[qkv.dtype], *common)
    name = "flash_qkv_fwd" if head else "flash_qkv_fwd_stream"
    _build.check(err, name)
    launches[name] += 1
    return _build.unpad_heads(o, heads, logical), lse


def flash_qkv_bwd_plain(
    qkv: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, heads: int,
    dim_head: int, scale: float, num_special: int = 0, seeds=None,
    rate: float = 0.0,
) -> torch.Tensor:
    """Plain torch K1b: ``dqkv [B, N, 3*H*Dh]`` in qkv's dtype, written as the
    explicit formulas of ``_head_bwd`` with the forward's mask replayed."""
    b, n, _ = qkv.shape
    inner = heads * dim_head
    dt = qkv.dtype
    thresh, inv_keep, seeds = dropout_args(seeds, rate)

    def split_heads(t):
        return t.reshape(b, n, heads, dim_head).permute(0, 2, 1, 3)

    q, k, v = (split_heads(t) for t in qkv.float().split(inner, dim=-1))
    g = split_heads(do.float())
    s = torch.matmul(q, k.transpose(-1, -2)) * scale  # f32 [B, H, N, N]
    sigma = torch.exp(s - lse.float()[..., None])
    if num_special:
        allowed = dual_query_allowed(n, n, num_special, device=qkv.device)
        sigma = torch.where(allowed, sigma, torch.zeros_like(sigma))
    dpd = torch.matmul(g, v.transpose(-1, -2))
    if thresh is not None:
        keep = keep_mask((b, heads, n, n), seeds, 0, thresh, device=qkv.device)
        zero = torch.zeros_like(sigma)
        pd = torch.where(keep, sigma * inv_keep, zero)
        dsigma = torch.where(keep, dpd * inv_keep, zero)
    else:
        pd, dsigma = sigma, dpd
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), g)
    rowsum = (dsigma * sigma).sum(dim=-1, keepdim=True)
    ds = (sigma * (dsigma - rowsum) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    merged = [t.permute(0, 2, 1, 3).reshape(b, n, inner) for t in (dq, dk, dv)]
    return torch.cat(merged, dim=-1).to(dt)


def flash_qkv_bwd(
    qkv: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, heads: int,
    dim_head: int, scale: float, num_special: int = 0, seeds=None,
    rate: float = 0.0, kernel: Optional[str] = None,
) -> torch.Tensor:
    """K1b: ``dqkv``; plain version on the CPU, a kernel on CUDA (as
    :func:`flash_qkv_fwd`, :func:`bwd_kernel`)."""
    if qkv.device.type == "cpu":
        return flash_qkv_bwd_plain(qkv, lse, do, heads, dim_head, scale, num_special,
                                   seeds, rate)
    _check_kernel_args("flash_qkv_bwd", qkv, heads, dim_head)
    b, n, _ = qkv.shape
    for name, t, shape, dtype in (("lse", lse, (b, heads, n), torch.float32),
                                  ("do", do, (b, n, heads * dim_head), qkv.dtype)):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != qkv.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_qkv_bwd: {name} must be contiguous {dtype} "
                             f"{shape} on {qkv.device}")
    logical, dim_head = dim_head, _build.kernel_dim_head("flash_qkv_bwd", dim_head)
    qkv = _build.pad_heads(qkv, 3 * heads, dim_head)
    do = _build.pad_heads(do, heads, dim_head)
    lib = _bwd_lib()
    if qkv.dtype == torch.bfloat16:
        _build.check_aligned("flash_qkv_bwd", qkv, do)
    fits = head_fits("bwd", n, dim_head, qkv.dtype) and b <= 65535  # the whole-head grid
    head = _build.whole_head("flash_qkv_bwd", kernel, fits,
                             fits and bwd_kernel(n, dim_head, qkv.dtype) == "flash_qkv_bwd")
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    dqkv = torch.empty_like(qkv)
    common = (float(scale), int(num_special), thresh or 0, float(inv_keep), s0, s1,
              int(thresh is not None), _build.stream_ptr(qkv))
    if head:
        err = lib.eavit_flash_qkv_bwd_head(
            _build.ptr(qkv), _build.ptr(lse), _build.ptr(do), _build.ptr(dqkv), b, n, heads,
            dim_head, *common)
    else:
        rowsum = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)  # scratch
        err = lib.eavit_flash_qkv_bwd(
            _build.ptr(qkv), _build.ptr(lse), _build.ptr(do), _build.ptr(dqkv),
            _build.ptr(rowsum), b, n, heads, dim_head, _build.DTYPE_CODES[qkv.dtype], *common)
    name = "flash_qkv_bwd" if head else "flash_qkv_bwd_stream"
    _build.check(err, name)
    launches[name] += 1
    return _build.unpad_heads(dqkv, 3 * heads, logical)


class _FlashQKV(torch.autograd.Function):
    """K1f forward, K1b backward. ``o`` is not saved: the backward
    recomputes sigma from ``qkv`` and ``lse``."""

    @staticmethod
    def forward(ctx, qkv, heads, dim_head, scale, num_special, seeds, rate):
        o, lse = flash_qkv_fwd(qkv, heads, dim_head, scale, num_special, seeds, rate)
        ctx.save_for_backward(qkv, lse)
        ctx.args = (heads, dim_head, scale, num_special,
                    None if seeds is None else (int(seeds[0]), int(seeds[1])), rate)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        qkv, lse = ctx.saved_tensors
        dqkv = flash_qkv_bwd(qkv, lse, do.contiguous(), *ctx.args)
        return (dqkv,) + (None,) * 6


def flash_mha_qkv(
    qkv: torch.Tensor,
    heads: int,
    dim_head: int,
    seeds=None,
    rate: float = 0.0,
    scale: Optional[float] = None,
    num_special: int = 0,
) -> torch.Tensor:
    """Multi-head attention from the raw qkv projection -> ``[B, N, H*Dh]``
    (``eavit_tpu/ops/flash_qkv.py:638-675``). ``seeds`` are two 32-bit
    words (``kernel_prng.seeds_from_generator``), needed when rate > 0."""
    if qkv.shape[-1] != 3 * heads * dim_head:
        raise ValueError(
            f"qkv last dim {qkv.shape[-1]} != 3*heads*dim_head ({3 * heads * dim_head})"
        )
    if scale is None:
        scale = dim_head ** -0.5
    return _FlashQKV.apply(qkv, heads, dim_head, scale, num_special, seeds, rate)


def flash_qkv_bits_plain(b: int, heads: int, n: int, seeds, device=None) -> torch.Tensor:
    """Plain K1r: the raw 24-bit values of the mask, int32 ``[B, H, N, N]``."""
    return raw_bits24(b * heads * n * n, seeds, 0, device).reshape(b, heads, n, n)


def flash_qkv_bits(b: int, heads: int, n: int, seeds, device) -> torch.Tensor:
    """K1r: replays the forward's mask stream; the keep mask the forward
    used is ``bits < keep_threshold(rate)``. Plain on the CPU, the kernel on
    CUDA (counterpart of ``dropout_raw_bits_qkv``, flash_qkv.py:702)."""
    device = torch.device(device)
    if device.type == "cpu":
        return flash_qkv_bits_plain(b, heads, n, seeds, device)
    if device.type != "cuda":
        raise ValueError(f"flash_qkv_bits: unsupported device {device}")
    out = torch.empty((b, heads, n, n), dtype=torch.int32, device=device)
    err = _lib().eavit_flash_qkv_bits(
        _build.ptr(out), out.numel(), int(seeds[0]), int(seeds[1]),
        _build.stream_ptr(out),
    )
    _build.check(err, "flash_qkv_bits")
    launches["flash_qkv_bits"] += 1
    return out
