"""Build and load the port's CUDA kernels (no counterpart in ``eavit_tpu``).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process into a shared
library with a plain C interface, all sources at once, and loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<hash>/lib<name>.so csrc/<name>.cu

No source includes PyTorch's headers, so a build takes seconds, not
minutes. The output goes under ``eavit_tpu_torch/_build/`` (listed in
``.gitignore``), in a directory named by a hash of every file in
``csrc/`` and the flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing is compiled at import: :func:`library` builds on
first use, so the package imports on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the shared memory one block of an H100 may opt in to
SMEM_LIMIT = 227 * 1024
# The longest sequence on which a wrapper with a whole-head bf16 kernel picks
# it over the streaming one: the whole-head K1f, K1b, K3b and K4b were the
# faster ones at the flagship's N = 198, and at N = 443 the streaming K1f and
# K4b were 13% and 29% faster (tune_attn_bwd.py, PERF.md); the crossover
# between is not measured.
HEAD_MAX_N = 256

# The head widths the attention kernels are instantiated for. A head of
# another width up to the last runs at the next of them, zero-padded
# (:func:`kernel_dim_head`, :func:`pad_last`, :func:`pad_heads`): zero
# columns add nothing to q k^T and give zero output columns, the scale stays
# the caller's, and the dropout mask is indexed over N x N, so the sliced
# result is the unpadded function's. Every streaming kernel takes each of
# them; the whole-head bf16 kernels (attn_fwd_head.cuh, attn_bwd_head.cuh)
# are instantiated up to HEAD_MAX_DIM_HEAD, so a wider head always streams.
DIM_HEADS = (16, 32, 64, 128)
HEAD_MAX_DIM_HEAD = 64

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Tuple[Path, str]:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started
    together) unless this hash was built before. Returns the directory and
    nvcc's output (ptxas register, spill and shared-memory report), kept
    beside the libraries for a later call that finds them built."""
    out_dir = BUILD_ROOT / _source_hash()
    sources = sorted(CSRC.glob("*.cu"))
    wanted = {s: out_dir / f"lib{s.stem}.so" for s in sources}
    log_path = out_dir / "nvcc.log"
    if all(p.exists() for p in wanted.values()):
        return out_dir, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, lib in wanted.items():
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    log_path.write_text(log)
    return out_dir, log


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[0] / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def whole_head(what: str, kernel: Optional[str], fits: bool, preferred: bool) -> bool:
    """Resolve the ``kernel`` argument of a wrapper with two bf16 kernels:
    ``None`` takes the whole-head kernel where the shape prefers it
    (``preferred``: it fits in shared memory and N <= ``HEAD_MAX_N``) and the
    streaming one otherwise; ``"head"`` and ``"stream"`` take one, and
    ``"head"`` raises where the head does not fit in one block's shared
    memory (``fits``)."""
    if kernel is None:
        return preferred
    if kernel == "stream":
        return False
    if kernel == "head":
        if not fits:
            raise ValueError(f"{what}: the whole-head kernel takes bf16 heads that fit "
                             f"in {SMEM_LIMIT} bytes of shared memory")
        return True
    raise ValueError(f"{what}: kernel {kernel!r} is not None, 'head' or 'stream'")


def check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    tensor-core kernels copy rows into shared memory 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must start on a 16-byte boundary "
                             f"(one at address {t.data_ptr():#x} does not)")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def kernel_dim_head(what: str, dim_head: int) -> int:
    """The width of the instantiated kernel that a head of ``dim_head`` runs
    at: the smallest of :data:`DIM_HEADS` that holds it. Raises past the
    widest."""
    for width in DIM_HEADS:
        if 1 <= dim_head <= width:
            return width
    raise ValueError(f"{what}: dim_head {dim_head} is not in 1..{DIM_HEADS[-1]}: no kernel "
                     f"takes it")


def pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` zero-padded on its last axis to ``width`` (``t`` itself where it
    has that width already)."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def pad_heads(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """A merged ``[..., heads*Dh]`` layout (K1's qkv with ``heads = 3*H``, its
    o and dO with ``H``) with each head zero-padded to ``width``."""
    dim_head = t.shape[-1] // heads
    if dim_head == width:
        return t
    lead = t.shape[:-1]
    return pad_last(t.reshape(*lead, heads, dim_head), width).reshape(*lead, heads * width)


def unpad_heads(t: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: each head's first ``dim_head``
    columns, merged and contiguous."""
    width = t.shape[-1] // heads
    if width == dim_head:
        return t
    lead = t.shape[:-1]
    return t.reshape(*lead, heads, width)[..., :dim_head].reshape(*lead, heads * dim_head)
