"""Flash attention with probability dropout in the kernel: K3f, K3b and K3r.

Counterpart of ``eavit_tpu/ops/flash_dropout.py``:
:func:`flash_attention_dropout` computes ``dropout(softmax(q k^T * scale)) v``
on ``[B, H, N, Dh]`` with the dual-query mask when ``num_special > 0``; it
is what the ``AttentionImpl = pallas`` route runs while dropout is live (at
act time and in every minibatch). At ``rate <= 0`` it delegates to
:func:`eavit_tpu_torch.ops.flash.flash_attention`, as lines 301-304 do.

The math is the TPU kernels'. Forward (``_fwd_kernel``, 123-147): f32 scores,
``sigma = p / l``, ``pd = keep ? sigma * inv_keep : 0``, ``o = pd v`` with
f32 sums, ``o`` in the input dtype, ``lse`` f32 ``[B, H, N]``. Backward
(``_bwd_kernel``, 150-191), from ``q``, ``k``, ``v``, ``lse`` and ``dO`` (no
O is saved, as ``_flash_drop_fwd`` at line 275 saves none): ``dv = pd^T dO``,
``dsigma = keep ? (dO v^T) * inv_keep : 0``, ``rowsum = sum(dsigma *
sigma)`` (the ``delta = sum(dO * O)`` trick is wrong under dropout),
``ds = sigma (dsigma - rowsum) scale``. Nothing but the outputs is rounded.

Dropout bits follow ``ops/kernel_prng.py``: Philox on the logical index
``((b*H + h)*N + i)*N + j`` of the ``[B, H, N, N]`` mask, stream 0, keyed by
the call's two seed words, ``keep = (bits >> 8) < thresh``. The TPU kernels'
core PRNG has no GPU twin, so the bits differ from the TPU's; the
distribution (24-bit keep threshold, exact inverse scale) is the same.

Two versions of each function: :func:`flash_dropout_fwd_plain`,
:func:`flash_dropout_bwd_plain` and :func:`dropout_raw_bits_plain` in plain
torch, and the CUDA kernels of ``csrc/flash_dropout.cu`` (K3f, replacing
``_fwd_kernel`` launched at flash_dropout.py:225; K3b, replacing
``_bwd_kernel`` launched at line 254; K3r, replacing ``_bits_kernel``
launched at line 349). K3f and K3b take bf16 inputs on the tensor cores
(``csrc/attn_fwd_mma.cuh``, ``csrc/attn_bwd_mma.cuh``; sigma', pd and ds
as two bf16 terms each, so that they keep float32 precision) and float32
inputs on the CUDA cores (``csrc/flash_stream.cuh``). All stream their
operands through shared memory in tiles of a fixed size, so they take any
N, where ``supports()`` (line 94) sends long sequences to the XLA path of
the same function; :func:`fwd_smem` and :func:`bwd_smem` report the
bytes, which depend on ``Dh`` and the dtype only. The wrappers take the
plain version for a CPU tensor and the kernel for a CUDA tensor; a CUDA
tensor the kernel does not take (another dtype or layout, ``Dh`` above 128,
bf16 not on a 16-byte boundary) raises before any launch; a head width
between the instantiated 16 / 32 / 64 / 128 (the whole-head K3b up to 64)
runs zero-padded to the next of them
(``_build.kernel_dim_head``), which is exact.
K3b has two bf16 kernels: where a head fits in one block's shared memory
and N <= 256 (``_build.HEAD_MAX_N``) the wrapper runs the whole-head form
(``csrc/attn_bwd_head.cuh``, one kernel that draws the mask once per head,
the faster one at the flagship N = 198), past that the streaming one
(:func:`bwd_kernel` says which; ``kernel="head"`` / ``"stream"`` takes one).
``launches`` counts wrapper calls that launched a kernel, each kernel under
its own key (``flash_dropout_bwd`` the whole-head K3b,
``flash_dropout_bwd_stream`` the streaming one, two CUDA launches, a dq
pass that also sums rowsum and a dk/dv pass, counted once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops import flash
from eavit_tpu_torch.ops.kernel_prng import dropout_args, keep_mask, raw_bits24

# wrapper calls that launched each kernel since the last reset (chip_smoke.py
# reads them)
launches = {"flash_dropout_fwd": 0, "flash_dropout_bwd": 0, "flash_dropout_bwd_stream": 0,
            "flash_dropout_bits": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    lib = _build.library("flash_dropout")
    if not getattr(lib, "_eavit_typed", False):
        vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        tail = [i, i, i, i, f, i, u, f, u, u, vp]
        lib.eavit_flash_dropout_fwd.argtypes = [vp] * 5 + tail
        lib.eavit_flash_dropout_fwd.restype = i
        lib.eavit_flash_dropout_bwd.argtypes = [vp] * 9 + tail
        lib.eavit_flash_dropout_bwd.restype = i
        lib.eavit_flash_dropout_bwd_head.argtypes = [vp] * 8 + tail[:3] + tail[4:]
        lib.eavit_flash_dropout_bwd_head.restype = i
        lib.eavit_flash_dropout_fwd_smem.argtypes = [i, i]  # Dh, dtype
        lib.eavit_flash_dropout_bwd_smem.argtypes = [i, i, i]  # Dh, dtype, pass
        lib.eavit_flash_dropout_bwd_head_smem.argtypes = [i, i]  # N, Dh
        for name in ("eavit_flash_dropout_fwd_smem", "eavit_flash_dropout_bwd_smem",
                     "eavit_flash_dropout_bwd_head_smem"):
            getattr(lib, name).restype = ctypes.c_size_t
        lib.eavit_flash_dropout_bits.argtypes = [vp, ctypes.c_ulonglong, u, u, vp]
        lib.eavit_flash_dropout_bits.restype = i
        lib._eavit_typed = True
    return lib


def fwd_smem(dim_head: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of one K3f block; N does not enter."""
    width = _build.kernel_dim_head("fwd_smem", dim_head)
    return _lib().eavit_flash_dropout_fwd_smem(width, _build.DTYPE_CODES[dtype])


def bwd_smem(dim_head: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Bytes of shared memory of one block of K3b's dq and dk/dv passes; N
    does not enter."""
    code = _build.DTYPE_CODES[dtype]
    width = _build.kernel_dim_head("bwd_smem", dim_head)
    return tuple(_lib().eavit_flash_dropout_bwd_smem(width, code, w) for w in (0, 1))


def head_fits(n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """Whether the whole-head bf16 K3b holds a head of ``n`` tokens in one
    block's shared memory."""
    width = _build.kernel_dim_head("head_fits", dim_head)
    return (dtype == torch.bfloat16 and width <= _build.HEAD_MAX_DIM_HEAD and
            _lib().eavit_flash_dropout_bwd_head_smem(n, width) <= _build.SMEM_LIMIT)


def bwd_kernel(n: int, dim_head: int, dtype: torch.dtype) -> str:
    """The ``launches`` key of the kernel a CUDA K3b call runs: the whole-head
    bf16 kernel where a head fits and N <= ``_build.HEAD_MAX_N``, else the
    streaming one."""
    head = n <= _build.HEAD_MAX_N and head_fits(n, dim_head, dtype)
    return "flash_dropout_bwd" if head else "flash_dropout_bwd_stream"


def _keep(q: torch.Tensor, seeds, thresh: int) -> torch.Tensor:
    b, h, n, _ = q.shape
    return keep_mask((b, h, n, n), seeds, 0, thresh, device=q.device)


def flash_dropout_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seeds, rate: float,
    scale: float, num_special: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K3f: ``(o [B, H, N, Dh] in q's dtype, lse [B, H, N] f32)``."""
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    s = flash.masked_scores(q, k, scale, num_special)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pd = p / l
    if thresh is not None:
        pd = torch.where(_keep(q, seeds, thresh), pd * inv_keep, torch.zeros_like(pd))
    o = torch.matmul(pd, v.float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_dropout_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, seeds, rate: float, scale: float, num_special: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Plain torch K3b: ``(dq, dk, dv)`` in q's dtype, as the explicit
    formulas of ``_bwd_kernel`` with the forward's mask replayed."""
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    g = do.float()
    sigma = torch.exp(flash.masked_scores(q, k, scale, num_special)
                      - lse.float()[..., None])
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    if thresh is not None:
        keep = _keep(q, seeds, thresh)
        zero = torch.zeros_like(sigma)
        pd = torch.where(keep, sigma * inv_keep, zero)
        dsigma = torch.where(keep, dp * inv_keep, zero)
    else:
        pd, dsigma = sigma, dp
    dv = torch.matmul(pd.transpose(-1, -2), g)
    rowsum = (dsigma * sigma).sum(dim=-1, keepdim=True)
    ds = sigma * (dsigma - rowsum) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _dropout_args(what: str, seeds, rate: float):
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    if thresh is None:
        raise ValueError(f"{what}: rate must be > 0 (rate 0 is ops/flash.py)")
    return thresh, inv_keep, s0, s1


def flash_dropout_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seeds, rate: float,
    scale: float, num_special: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3f: ``(o, lse)``; plain version on the CPU, the kernel on CUDA."""
    thresh, inv_keep, s0, s1 = _dropout_args("flash_dropout_fwd", seeds, rate)
    if q.device.type == "cpu":
        return flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, num_special)
    flash.check_kernel_args("flash_dropout_fwd", q, k, v)
    b, h, n, dim_head = q.shape
    dh = _build.kernel_dim_head("flash_dropout_fwd", dim_head)
    q, k, v = (_build.pad_last(t, dh) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        _build.check_aligned("flash_dropout_fwd", q, k, v)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = lib.eavit_flash_dropout_fwd(
        *(_build.ptr(t) for t in (q, k, v, o, lse)), b * h, n, dh,
        _build.DTYPE_CODES[q.dtype], float(scale), int(num_special), thresh,
        float(inv_keep), s0, s1, _build.stream_ptr(q))
    _build.check(err, "flash_dropout_fwd")
    launches["flash_dropout_fwd"] += 1
    return o[..., :dim_head].contiguous(), lse


def flash_dropout_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, seeds, rate: float, scale: float, num_special: int = 0,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """K3b: ``(dq, dk, dv)``; plain version on the CPU, a kernel on CUDA (the
    whole-head or the streaming one, :func:`bwd_kernel`; ``kernel`` =
    ``"head"`` or ``"stream"`` takes one)."""
    thresh, inv_keep, s0, s1 = _dropout_args("flash_dropout_bwd", seeds, rate)
    if q.device.type == "cpu":
        return flash_dropout_bwd_plain(q, k, v, lse, do, seeds, rate, scale, num_special)
    flash.check_kernel_args("flash_dropout_bwd", q, k, v, do, lse=lse)
    b, h, n, dim_head = q.shape
    dh = _build.kernel_dim_head("flash_dropout_bwd", dim_head)
    q, k, v, do = (_build.pad_last(t, dh) for t in (q, k, v, do))
    lib = _lib()
    if q.dtype == torch.bfloat16:
        _build.check_aligned("flash_dropout_bwd", q, k, v, do)
    head = _build.whole_head("flash_dropout_bwd", kernel, head_fits(n, dh, q.dtype),
                             bwd_kernel(n, dh, q.dtype) == "flash_dropout_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    common = (float(scale), int(num_special), thresh, float(inv_keep), s0, s1,
              _build.stream_ptr(q))
    if head:
        err = lib.eavit_flash_dropout_bwd_head(
            *(_build.ptr(t) for t in (q, k, v, lse, do, dq, dk, dv)), b * h, n, dh, *common)
    else:
        rowsum = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # scratch
        err = lib.eavit_flash_dropout_bwd(
            *(_build.ptr(t) for t in (q, k, v, lse, do, dq, dk, dv, rowsum)), b * h, n, dh,
            _build.DTYPE_CODES[q.dtype], *common)
    name = "flash_dropout_bwd" if head else "flash_dropout_bwd_stream"
    _build.check(err, name)
    launches[name] += 1
    return tuple(t[..., :dim_head].contiguous() for t in (dq, dk, dv))


class _FlashDropout(torch.autograd.Function):
    """K3f forward, K3b backward. ``o`` is not saved: the backward
    recomputes sigma from ``q``, ``k`` and ``lse`` and replays the mask."""

    @staticmethod
    def forward(ctx, q, k, v, seeds, rate, scale, num_special):
        o, lse = flash_dropout_fwd(q, k, v, seeds, rate, scale, num_special)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (seeds, rate, scale, num_special)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 7
        q, k, v, lse = ctx.saved_tensors
        return flash_dropout_bwd(q, k, v, lse, do.contiguous(), *ctx.args) + (None,) * 4


def flash_attention_dropout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seeds, rate: float,
    scale: Optional[float] = None, num_special: int = 0,
) -> torch.Tensor:
    """``dropout(softmax(q k^T * scale)) v`` on ``[B, H, N, Dh]``
    (``eavit_tpu/ops/flash_dropout.py:283-319``). ``seeds`` are two 32-bit
    words (``kernel_prng.seeds_from_generator``), needed when rate > 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if rate <= 0.0:
        return flash.flash_attention(q, k, v, scale=scale, num_special=num_special)
    if seeds is None:
        raise ValueError("rate > 0 requires seeds")
    return _FlashDropout.apply(q, k, v, (int(seeds[0]), int(seeds[1])), float(rate),
                               float(scale), int(num_special))


def dropout_raw_bits_plain(b: int, h: int, n: int, seeds, device=None) -> torch.Tensor:
    """Plain K3r: the raw 24-bit values of the mask, int32 ``[B, H, N, N]``."""
    return raw_bits24(b * h * n * n, seeds, 0, device).reshape(b, h, n, n)


def dropout_raw_bits(b: int, h: int, n: int, seeds, device) -> torch.Tensor:
    """K3r: replays the mask stream of K3f / K3b; the keep mask they used is
    ``bits < keep_threshold(rate)`` (counterpart of ``dropout_raw_bits``,
    flash_dropout.py:337). Plain on the CPU, the kernel on CUDA."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_raw_bits_plain(b, h, n, seeds, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_raw_bits: unsupported device {device}")
    out = torch.empty((b, h, n, n), dtype=torch.int32, device=device)
    err = _lib().eavit_flash_dropout_bits(
        _build.ptr(out), out.numel(), int(seeds[0]), int(seeds[1]),
        _build.stream_ptr(out))
    _build.check(err, "flash_dropout_bits")
    launches["flash_dropout_bits"] += 1
    return out
