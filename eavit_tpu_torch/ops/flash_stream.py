"""KV-streaming flash attention on ``[B, H, N, Dh]``: K5f, K5q and K5kv.

Counterpart of ``eavit_tpu/ops/flash_stream.py``: :func:`flash_attention_stream`
computes ``softmax(q k^T * scale) v`` per head with the dual-query mask when
``num_special > 0`` (``ops/attention.py``) and no dropout; it is what the
``AttentionImpl = pallas_stream`` route runs. The math is the TPU kernels':
the forward (``_fwd_kernel``, lines 99-137) takes f32 scores and the online
softmax over key tiles, writes ``o`` in the input dtype and ``lse`` as f32
``[B, H, N]``; the backward recomputes ``p = exp(s - lse)`` and takes
``ds = p (dO v^T - delta) scale`` in two passes, ``dq = ds k``
(``_bwd_dq_kernel``, 183-218) and ``dk = ds^T q``, ``dv = p^T dO``
(``_bwd_dkv_kernel``, 221-262). ``delta = sum(dO * O)`` per row is computed
outside the kernels from the rounded O the forward returned, as the JAX
package does in XLA (lines 273-274): :func:`stream_delta`.

Two versions of each function:

- :func:`flash_stream_fwd_plain`, :func:`flash_stream_dq_plain` and
  :func:`flash_stream_dkv_plain` (with :func:`flash_stream_bwd_plain`, both
  passes): plain torch, the oracle, one untiled computation each;
- the CUDA kernels of ``csrc/flash_stream.cu``: K5f ``flash_stream_fwd``
  (replaces ``_fwd_kernel``, launched at flash_stream.py:159), K5q
  ``flash_stream_dq`` (``_bwd_dq_kernel``, line 285) and K5kv
  ``flash_stream_dkv`` (``_bwd_dkv_kernel``, line 304). The bf16 K5f runs on
  the tensor cores, the streaming forward ``csrc/attn_fwd_mma.cuh`` in its
  one-sweep mode (the online softmax, p as two bf16 terms); the float32 one
  on the CUDA-core template ``csrc/flash_stream.cuh``. The bf16 K5q
  and K5kv run on the tensor cores, as the dq kernel and the dk/dv kernel of
  ``csrc/attn_bwd_mma.cuh`` launched one at a time, with p and ds kept f32
  as two bf16 terms each and the caller's ``delta``, which neither writes;
  the float32 ones on ``flash_stream.cuh``. Every kernel's shared memory
  depends on ``Dh`` and the dtype only (:func:`smem_bytes`), so they take
  any N.

The wrappers take the plain version for a tensor on the CPU and launch the
kernel for a CUDA tensor; a CUDA tensor the kernel does not take (another
dtype or layout, ``Dh`` above 128, a bf16 operand not on a 16-byte
boundary) raises before any launch; a head width between the instantiated
16 / 32 / 64 / 128 runs zero-padded to the next of them
(``_build.kernel_dim_head``), which is exact.
:func:`flash_attention_stream` is differentiable through one
``torch.autograd.Function`` that saves ``(q, k, v, o, lse)`` as
``_flash_stream_fwd`` does (line 337). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops.flash import check_kernel_args, masked_scores

# launches of each kernel since the last reset (chip_smoke.py reads them)
launches = {"flash_stream_fwd": 0, "flash_stream_dq": 0, "flash_stream_dkv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = _build.library("flash_stream")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, f, i, vp]  # BH, N, Dh, dtype, scale, num_special, stream
        lib.eavit_flash_stream_fwd.argtypes = [vp] * 5 + tail
        lib.eavit_flash_stream_dq.argtypes = [vp] * 7 + tail
        lib.eavit_flash_stream_dkv.argtypes = [vp] * 8 + tail
        for name in ("fwd", "dq", "dkv"):
            getattr(lib, f"eavit_flash_stream_{name}").restype = i
            smem = getattr(lib, f"eavit_flash_stream_{name}_smem")
            smem.argtypes, smem.restype = [i, i], ctypes.c_size_t  # Dh, dtype
        lib._eavit_typed = True
    return lib


def smem_bytes(kernel: str, dim_head: int, dtype: torch.dtype) -> int:
    """Shared-memory bytes of one block of K5 ``kernel`` (``"fwd"``, ``"dq"``
    or ``"dkv"``) at head width ``dim_head`` in ``dtype``; N does not
    enter."""
    return getattr(_lib(), f"eavit_flash_stream_{kernel}_smem")(
        _build.kernel_dim_head("smem_bytes", dim_head), _build.DTYPE_CODES[dtype])


def flash_stream_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K5f: ``(o [B, H, N, Dh] in q's dtype, lse [B, H, N] f32)``."""
    s = masked_scores(q, k, scale, num_special)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def stream_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = sum(dO * O)`` per row, f32 ``[B, H, N]``, from the O the
    forward returned."""
    return (do.float() * o.float()).sum(dim=-1)


def _probs_and_ds(q, k, v, lse, delta, do, scale, num_special):
    """f32 ``p = exp(s - lse)`` (0 where masked) and ``ds = p (dO v^T -
    delta) scale``, both ``[B, H, N, N]``."""
    p = torch.exp(masked_scores(q, k, scale, num_special) - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.float()[..., None]) * scale


def flash_stream_dq_plain(q, k, v, lse, delta, do, scale: float,
                          num_special: int = 0) -> torch.Tensor:
    """Plain torch K5q: ``dq = ds k`` in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, lse, delta, do, scale, num_special)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_stream_dkv_plain(q, k, v, lse, delta, do, scale: float,
                           num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K5kv: ``(dk = ds^T q, dv = p^T dO)`` in q's dtype."""
    p, ds = _probs_and_ds(q, k, v, lse, delta, do, scale, num_special)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_stream_bwd_plain(q, k, v, lse, delta, do, scale: float,
                           num_special: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain torch K5q and K5kv: ``(dq, dk, dv)``."""
    args = (q, k, v, lse, delta, do, scale, num_special)
    return (flash_stream_dq_plain(*args),) + flash_stream_dkv_plain(*args)


def _launch(name: str, inputs, outputs, q: torch.Tensor, scale: float,
            num_special: int) -> None:
    b, h, n, dh = q.shape
    err = getattr(_lib(), f"eavit_flash_stream_{name}")(
        *(_build.ptr(t) for t in (*inputs, *outputs)), b * h, n, dh,
        _build.DTYPE_CODES[q.dtype], float(scale), int(num_special), _build.stream_ptr(q))
    _build.check(err, f"flash_stream_{name}")
    launches[f"flash_stream_{name}"] += 1


def flash_stream_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5f: ``(o, lse)``; plain version on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_stream_fwd_plain(q, k, v, scale, num_special)
    check_kernel_args("flash_stream_fwd", q, k, v)
    dim_head = q.shape[-1]
    q, k, v = _padded("flash_stream_fwd", q, k, v)
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies 16-byte rows
        _build.check_aligned("flash_stream_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fwd", (q, k, v), (o, lse), q, scale, num_special)
    return o[..., :dim_head].contiguous(), lse


def _padded(what: str, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands at the width of the kernel that takes their heads."""
    width = _build.kernel_dim_head(what, ts[0].shape[-1])
    return tuple(_build.pad_last(t, width) for t in ts)


def _check_bwd_args(what, q, k, v, lse, delta, do):
    """The checked operands ``(q, k, v, do)``, padded to the kernel's width."""
    check_kernel_args(what, q, k, v, do, lse=lse)
    check_kernel_args(what, q, lse=delta)
    q, k, v, do = _padded(what, q, k, v, do)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels copy 16-byte rows
        _build.check_aligned(what, q, k, v, do)
    return q, k, v, do


def flash_stream_dq(q, k, v, lse, delta, do, scale: float,
                    num_special: int = 0) -> torch.Tensor:
    """K5q: ``dq``; plain version on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_stream_dq_plain(q, k, v, lse, delta, do, scale, num_special)
    dim_head = q.shape[-1]
    q, k, v, do = _check_bwd_args("flash_stream_dq", q, k, v, lse, delta, do)
    dq = torch.empty_like(q)
    _launch("dq", (q, k, v, lse, delta, do), (dq,), q, scale, num_special)
    return dq[..., :dim_head].contiguous()


def flash_stream_dkv(q, k, v, lse, delta, do, scale: float,
                     num_special: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5kv: ``(dk, dv)``; plain version on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_stream_dkv_plain(q, k, v, lse, delta, do, scale, num_special)
    dim_head = q.shape[-1]
    q, k, v, do = _check_bwd_args("flash_stream_dkv", q, k, v, lse, delta, do)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("dkv", (q, k, v, lse, delta, do), (dk, dv), q, scale, num_special)
    return dk[..., :dim_head].contiguous(), dv[..., :dim_head].contiguous()


def flash_stream_bwd(q, k, v, lse, delta, do, scale: float,
                     num_special: int = 0) -> Tuple[torch.Tensor, ...]:
    """K5q and K5kv: ``(dq, dk, dv)``."""
    args = (q, k, v, lse, delta, do, scale, num_special)
    return (flash_stream_dq(*args),) + flash_stream_dkv(*args)


class _FlashStream(torch.autograd.Function):
    """K5f forward; K5q and K5kv backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_special):
        o, lse = flash_stream_fwd(q, k, v, scale, num_special)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, num_special)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 5
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        return flash_stream_bwd(q, k, v, lse, stream_delta(o, do), do,
                                *ctx.args) + (None, None)


def flash_attention_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None,
                           num_special: int = 0) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` on ``[B, H, N, Dh]`` with the streaming
    flash backward (``eavit_tpu/ops/flash_stream.py:343-358``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashStream.apply(q, k, v, float(scale), int(num_special))
