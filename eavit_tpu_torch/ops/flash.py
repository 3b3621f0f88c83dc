"""Flash attention on ``[B, H, N, Dh]``: K4f and K4b.

Counterpart of ``eavit_tpu/ops/flash.py``: :func:`flash_attention` computes
``softmax(q k^T * scale) v`` per head with the dual-query mask when
``num_special > 0`` (``ops/attention.py``) and no dropout; it is what the
``AttentionImpl = pallas`` route runs for deterministic forwards and at
dropout 0. The math is the TPU kernels': the forward (``_fwd_kernel``,
lines 74-104) takes f32 scores, ``p = exp(s - m)``, ``o = (p v) / l`` with
``p`` unrounded, ``o`` cast to the input dtype, and the row log-sum-exp
``lse = m + log l`` as f32 ``[B, H, N]``. The backward (``_bwd_kernel``,
147-189) recomputes ``p = exp(s - lse)``, takes ``delta = sum(dO * O)`` per
row from the forward's O, ``ds = p (dO v^T - delta) scale``, and writes
``dq``, ``dk`` and ``dv`` (f32 sums) once each in the input dtype.

Two versions of each function:

- :func:`flash_fwd_plain` / :func:`flash_bwd_plain`: plain torch, the oracle;
- the CUDA kernels of ``csrc/flash.cu`` (K4f ``flash_fwd``, which replaces
  ``_fwd_kernel`` launched at flash.py:125, and K4b ``flash_bwd``, which
  replaces ``_bwd_kernel`` launched at line 217). bf16 inputs run on the
  tensor cores (``csrc/attn_fwd_mma.cuh``, ``csrc/attn_bwd_mma.cuh``),
  float32 on the CUDA cores (``csrc/flash_stream.cuh``). All stream K and V
  (the backward's dk/dv pass Q and dO) through shared memory in tiles of a
  fixed size, so they take any N, as ``eavit_tpu``'s kernel does by
  blocking its rows down to one per cell (flash.py:63-66);
  :func:`fwd_smem` and :func:`bwd_smem` report the bytes, which depend on
  ``Dh`` and the dtype only.

:func:`flash_fwd` and :func:`flash_bwd` take the plain version for a tensor
on the CPU and launch the kernel for a CUDA tensor; a CUDA tensor the
kernel does not take (another dtype or layout, ``Dh`` above 128, bf16 not on
a 16-byte boundary) raises before any launch. The kernels are instantiated
at ``Dh`` 16, 32, 64 and 128 (the whole-head K4b up to 64); a head of another
width up to 128 runs at the next of them, zero-padded, and the outputs are sliced back
(``_build.kernel_dim_head``), which is exact.
:func:`flash_attention` is differentiable through one
``torch.autograd.Function`` that saves ``(q, k, v, o, lse)`` as
``_flash_fwd`` does (line 244). K4b has two bf16 kernels: where a head fits
in one block's shared memory and N <= 256 (``_build.HEAD_MAX_N``) the
wrapper runs the whole-head form (``csrc/attn_bwd_head.cuh``, the faster
one at the flagship N = 198), past that the streaming one
(:func:`bwd_kernel` says which; ``kernel="head"`` / ``"stream"`` takes
one). ``launches`` counts wrapper
calls that launched a kernel, each kernel under its own key (``flash_bwd``
the whole-head K4b, ``flash_bwd_stream`` the streaming one, two CUDA
launches, a dq pass that also sums delta and a dk/dv pass, counted once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops.attention import dual_query_allowed

# wrapper calls that launched each kernel since the last reset (chip_smoke.py
# reads them)
launches = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_stream": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = _build.library("flash")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.eavit_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, f, i, vp]
        lib.eavit_flash_fwd.restype = i
        lib.eavit_flash_bwd.argtypes = [vp] * 10 + [i, i, i, i, f, i, vp]
        lib.eavit_flash_bwd.restype = i
        lib.eavit_flash_bwd_head.argtypes = [vp] * 9 + [i, i, i, f, i, vp]
        lib.eavit_flash_bwd_head.restype = i
        lib.eavit_flash_fwd_smem.argtypes = [i, i]  # Dh, dtype
        lib.eavit_flash_bwd_smem.argtypes = [i, i, i]  # Dh, dtype, pass
        lib.eavit_flash_bwd_head_smem.argtypes = [i, i]  # N, Dh
        for name in ("eavit_flash_fwd_smem", "eavit_flash_bwd_smem",
                     "eavit_flash_bwd_head_smem"):
            getattr(lib, name).restype = ctypes.c_size_t
        lib._eavit_typed = True
    return lib


def masked_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                  num_special: int) -> torch.Tensor:
    """f32 ``q k^T * scale`` ``[B, H, N, N]``, -inf where the dual-query mask
    forbids the edge."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if num_special:
        n = q.shape[2]
        s = s.masked_fill(~dual_query_allowed(n, n, num_special, q.device), float("-inf"))
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K4f: ``(o [B, H, N, Dh] in q's dtype, lse [B, H, N] f32)``."""
    s = masked_scores(q, k, scale, num_special)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, scale: float,
                    num_special: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain torch K4b: ``(dq, dk, dv)`` in q's dtype, as the explicit
    formulas of ``_bwd_kernel``."""
    g = do.float()
    p = torch.exp(masked_scores(q, k, scale, num_special) - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    delta = (g * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def check_kernel_args(what: str, q: torch.Tensor, *like_q: torch.Tensor,
                      lse: Optional[torch.Tensor] = None) -> None:
    """Raise unless q (and every tensor of ``like_q``) is a contiguous CUDA
    ``[B, H, N, Dh]`` tensor the kernels take, and ``lse`` f32 ``[B, H, N]``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype} (float32 or bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"{what}: shape {tuple(q.shape)} is not [B, H, N, Dh]")
    _build.kernel_dim_head(what, q.shape[-1])
    for t in (q, *like_q):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous {q.dtype} "
                             f"{tuple(q.shape)} tensors on {q.device}")
    if lse is not None and (tuple(lse.shape) != tuple(q.shape[:3])
                            or lse.dtype != torch.float32 or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"{what}: lse must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}")


def fwd_smem(dim_head: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of one K4f block; N does not enter."""
    width = _build.kernel_dim_head("fwd_smem", dim_head)
    return _lib().eavit_flash_fwd_smem(width, _build.DTYPE_CODES[dtype])


def bwd_smem(dim_head: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Bytes of shared memory of one block of K4b's dq and dk/dv passes; N
    does not enter."""
    code = _build.DTYPE_CODES[dtype]
    width = _build.kernel_dim_head("bwd_smem", dim_head)
    return tuple(_lib().eavit_flash_bwd_smem(width, code, w) for w in (0, 1))


def head_fits(n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """Whether the whole-head bf16 K4b holds a head of ``n`` tokens in one
    block's shared memory."""
    width = _build.kernel_dim_head("head_fits", dim_head)
    return (dtype == torch.bfloat16 and width <= _build.HEAD_MAX_DIM_HEAD and
            _lib().eavit_flash_bwd_head_smem(n, width) <= _build.SMEM_LIMIT)


def bwd_kernel(n: int, dim_head: int, dtype: torch.dtype) -> str:
    """The ``launches`` key of the kernel a CUDA K4b call runs: the whole-head
    bf16 kernel where a head fits and N <= ``_build.HEAD_MAX_N``, else the
    streaming one."""
    head = n <= _build.HEAD_MAX_N and head_fits(n, dim_head, dtype)
    return "flash_bwd" if head else "flash_bwd_stream"


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4f: ``(o, lse)``; plain version on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, num_special)
    check_kernel_args("flash_fwd", q, k, v)
    b, h, n, dim_head = q.shape
    dh = _build.kernel_dim_head("flash_fwd", dim_head)
    q, k, v = (_build.pad_last(t, dh) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        _build.check_aligned("flash_fwd", q, k, v)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = lib.eavit_flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(lse),
        b * h, n, dh, _build.DTYPE_CODES[q.dtype], float(scale), int(num_special),
        _build.stream_ptr(q))
    _build.check(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return o[..., :dim_head].contiguous(), lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, do: torch.Tensor, scale: float,
              num_special: int = 0, kernel: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """K4b: ``(dq, dk, dv)``; plain version on the CPU, a kernel on CUDA (the
    whole-head or the streaming one, :func:`bwd_kernel`; ``kernel`` =
    ``"head"`` or ``"stream"`` takes one)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale, num_special)
    check_kernel_args("flash_bwd", q, k, v, o, do, lse=lse)
    b, h, n, dim_head = q.shape
    dh = _build.kernel_dim_head("flash_bwd", dim_head)
    q, k, v, o, do = (_build.pad_last(t, dh) for t in (q, k, v, o, do))
    if q.dtype == torch.bfloat16:
        _build.check_aligned("flash_bwd", q, k, v, o, do)
    lib = _lib()
    head = _build.whole_head("flash_bwd", kernel, head_fits(n, dh, q.dtype),
                             bwd_kernel(n, dh, q.dtype) == "flash_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    tail = (b * h, n, dh)
    common = (float(scale), int(num_special), _build.stream_ptr(q))
    if head:
        err = lib.eavit_flash_bwd_head(
            *(_build.ptr(t) for t in (q, k, v, o, lse, do, dq, dk, dv)), *tail, *common)
    else:
        delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # scratch
        err = lib.eavit_flash_bwd(
            *(_build.ptr(t) for t in (q, k, v, o, lse, do, dq, dk, dv, delta)), *tail,
            _build.DTYPE_CODES[q.dtype], *common)
    name = "flash_bwd" if head else "flash_bwd_stream"
    _build.check(err, name)
    launches[name] += 1
    return tuple(t[..., :dim_head].contiguous() for t in (dq, dk, dv))


class _Flash(torch.autograd.Function):
    """K4f forward, K4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_special):
        o, lse = flash_fwd(q, k, v, scale, num_special)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, num_special)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 5
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.args) + (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, num_special: int = 0) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` on ``[B, H, N, Dh]`` with the flash
    backward (``eavit_tpu/ops/flash.py:252-268``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, float(scale), int(num_special))
