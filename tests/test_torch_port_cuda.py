"""The torch port's CUDA kernels against their plain torch versions.

Needs an NVIDIA GPU and the CUDA toolkit: every test skips without a CUDA
device. The file imports neither JAX nor ``eavit_tpu``, so it runs where
only PyTorch is installed; there, skip the repository's conftest (which
configures JAX):

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: the replay kernels must equal the plain Philox bit for bit;
K1f, K2f and K1b in bf16 may differ from the plain version by one bf16
rounding of the output (2^-8 relative) because they sum in another order;
K2f in float32 by 1e-4 of the output's scale; lse by 1e-4. K2b (every
product on the tensor cores, float32 operands as hi + lo bf16 terms) has its
seven outputs judged each against its own maximum (float32 1e-4; bf16 input:
one bf16 rounding of dx, 2e-3 for the float32 parameter gradients, where a
sum that lands on a rounding boundary of dh or gd flips the operand). The
backward kernels are also held to torch autograd through the plain forward
(float32, 1e-4), and two identical calls must give equal bits: neither
kernel sums with atomics. K3 and K4 (flash attention on [B, H, N, Dh]) are
held to their plain versions at one bf16 rounding of each output in bf16 and
1e-4 of its scale in float32, K3r bit for bit; their backward kernels also
to autograd through the plain forward, and give equal bits twice. K5 (the
KV-streaming kernels) is held to its plain version at the same tolerances,
at N up to 640 and in one call at 3,137, and gives equal bits twice. Its
bf16 K5f runs the one-sweep mode of the tensor-core forward
(csrc/attn_fwd_mma.cuh): at N 198, 443 and 3,137, Dh 16 / 32 / 64 and
num_special 0 / 2 it is held to its plain version at one bf16 rounding of o
and 1e-4 on lse, with equal bits twice and the shared memory of K4f's
forward, whatever N is. Its bf16 K5q and K5kv run the dq and the dk/dv
kernel of the tensor-core
backward (csrc/attn_bwd_mma.cuh) with the caller's delta: each is called
alone, K5kv first on a fresh delta, at N 11, 197, 198, 443, 640 and 3,137,
Dh 16 / 32 / 64, num_special 0 / 2, within one bf16 rounding of the plain
version with equal bits twice and delta left as it was; the cancellation
test holds K5q too, and a bf16 operand off a 16-byte boundary raises.

K1b and K3b in bf16 run on the tensor cores (csrc/attn_bwd_mma.cuh), on
16-row tiles with zero rows past N: they are held to their plain versions
at N around the tiles (15, 16, 17, 37, 197, 198, 199, and 443 at Dh 16
and 32), Dh 16 / 32 / 64, num_special 0 / 2 and an
odd batch, at one bf16 rounding of each output (2^-8 relative, as above:
K1b's products are the plain version's exactly, pd and ds rounded to bf16
as the JAX kernel rounds them, and only the sum order differs; K3b's pd and
ds enter as two bf16 terms, 2^-17 relative, far inside that), with equal
bits twice and one launch per call. The cancellation test makes every key
8 + 0.01 noise, so that dq = sum_j ds_ij k_j, whose ds_ij sum to 0, nearly
cancels: there a bf16 ds would err by about dq itself, and K3b, which keeps
pd and ds in float32 as the JAX kernel does, must err at most a tenth as
much as the dq that rounding ds gives (the plain K1b on the same inputs);
the K1b kernel matches that plain K1b at one bf16 rounding.

The bf16 K1f, K3f and K4f (csrc/attn_fwd_mma.cuh) and K4b (attn_bwd_mma.cuh
with delta from O) run on the tensor cores too: they are held to their plain
versions at N 11, 197, 198 and 443, Dh 16 / 32 / 64, num_special 0 / 2 (K1f
also at rate 0 and 0.1), at one bf16 rounding of each output and 1e-4 on
lse, with equal bits twice; the cancellation test also holds K4b. Every
function of K1, K3 and K4 has a kernel that streams its operands through
shared memory of a size that depends on Dh and the dtype only; K1f, K1b,
K3b and K4b also have a whole-head bf16 kernel, which their wrappers run
where a head fits in shared memory. Each function, in bf16 and float32, by
shape and forced onto its streaming kernel, is held to its plain version at
N = 37, 198, 443, 786 and 1,766 with one launch per call under the launch
key of the kernel that ran and equal bits twice, and runs at N = 3,137; the
ragged-N, cancellation and tensor-core tests run both kernels; a dtype or
Dh the kernels refuse raises at any N. Every attention function also runs
at head widths between the instantiated 16 / 32 / 64 / 128 (8, 24, 40, 48,
60, 96), zero-padded to the next of them, and at 128 on the streaming
kernels (N 198 and 443, both dtypes and rates), held to its plain version at
the true width; only Dh above 128 raises. K2f and K2b run at every dim and
hidden width: the fused kernels where dim % 32 == 0, dim <= 256 and hidden
% 32 == 0, the split path (ffn_wide.cuh) elsewhere, held to their plain
versions at (40, 100), (384, 1,536), (768, 3,072), (1,024, 4,096), (1,280,
5,120) and (1,031, 100) too, with equal bits twice, K2f with zeros exactly
where K2r's mask2 drops. The network's loss and backward, run twice on the
same inputs, gives every kernel output the same bits.
"""

import math

import numpy as np
import pytest
import torch

from eavit_tpu_torch.ops import _build
from eavit_tpu_torch.ops import flash as fl
from eavit_tpu_torch.ops import flash_dropout as fd
from eavit_tpu_torch.ops import flash_qkv as fq
from eavit_tpu_torch.ops import flash_stream as fs
from eavit_tpu_torch.ops import fused_ffn as ff
from eavit_tpu_torch.ops.kernel_prng import keep_threshold


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _bf16_tol(ref):
    return 1e-2 + 8e-3 * ref.float().abs().max().item()


def test_replay_kernels_match_plain_bit_for_bit(cuda):
    seeds = (0xDEADBEEF, 0x12345678)
    dev = fq.flash_qkv_bits(3, 8, 198, seeds, cuda)
    assert torch.equal(dev, fq.flash_qkv_bits_plain(3, 8, 198, seeds, cuda))
    d1, d2 = ff.fused_ffn_bits(37, 256, 1024, seeds, cuda)
    p1, p2 = ff.fused_ffn_bits_plain(37, 256, 1024, seeds, cuda)
    assert torch.equal(d1, p1) and torch.equal(d2, p2)


def _qkv(b, n, heads, dim_head, device, dtype):
    g = torch.Generator().manual_seed(b * 1000 + n)
    return torch.randn(b, n, 3 * heads * dim_head, generator=g).to(device, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,num_special,dim_head,dtype", [
    (64, 198, 2, 32, torch.bfloat16),   # shared-patch-stream act shape
    (128, 197, 0, 32, torch.bfloat16),  # exact stacked act shape
    (3, 37, 2, 16, torch.float32),
    (2, 70, 0, 64, torch.bfloat16),
])
def test_flash_qkv_kernel_matches_plain(cuda, b, n, num_special, dim_head, dtype, rate):
    heads, seeds = 8, (123, 456)
    x = _qkv(b, n, heads, dim_head, cuda, dtype)
    args = (heads, dim_head, dim_head ** -0.5, num_special, seeds, rate)
    o, lse = fq.flash_qkv_fwd(x, *args)
    po, plse = fq.flash_qkv_fwd_plain(x, *args)
    torch.cuda.synchronize()
    tol = _bf16_tol(po) if dtype == torch.bfloat16 else 1e-4
    assert _max_err(o, po) <= tol
    assert _max_err(lse, plse) <= 1e-4


def test_flash_qkv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 5, 3 * 2 * 136, device=cuda)
    with pytest.raises(ValueError, match="dim_head 136"):
        fq.flash_qkv_fwd(x, 2, 136, 0.2)  # no kernel takes dim_head > 128
    with pytest.raises(TypeError):
        fq.flash_qkv_fwd(x.half(), 2, 136, 0.2)
    # the backward refuses the same, and operands that do not match qkv
    ok = torch.zeros(2, 5, 3 * 2 * 32, device=cuda)
    lse, do = torch.zeros(2, 2, 5, device=cuda), torch.zeros(2, 5, 2 * 32, device=cuda)
    with pytest.raises(ValueError):
        fq.flash_qkv_bwd(ok, lse, do.half(), 2, 32, 0.2)  # dO in another dtype
    with pytest.raises(ValueError):
        fq.flash_qkv_bwd(ok, lse[:, :1], do, 2, 32, 0.2)  # lse of another shape


def _ffn_inputs(rows, dim, hidden, device, dtype):
    g = torch.Generator().manual_seed(rows)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = f(rows, dim).to(device, dtype)
    params = (1.0 + 0.1 * f(dim), 0.1 * f(dim), f(hidden, dim) / math.sqrt(dim),
              0.1 * f(hidden), f(dim, hidden) / math.sqrt(hidden), 0.1 * f(dim))
    return x, tuple(p.to(device) for p in params)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,hidden", [
    (64 * 198, 256, 1024),   # shared-patch-stream act rows
    (128 * 197, 256, 1024),  # exact stacked act rows
    (256 * 198, 256, 1024),  # shared-patch-stream minibatch
    (8 * 198, 256, 1024),    # the gradient check's 8 frames: a partial last block
    (1001, 256, 1024),       # rows that no row tile divides
    (45, 64, 96),
    (37, 40, 100),           # ragged widths: the split path
    (37, 37, 100),           # dim % 4 != 0: rows not 16-byte aligned
    (1000, 384, 1536),
    (512, 768, 3072),
    (256, 1024, 4096),       # the HF flavour's width
    (256, 1280, 5120),       # wider than any model the JAX package names
    (37, 1031, 100),         # an odd dim past 1,024
])
def test_fused_ffn_kernel_matches_plain(cuda, rows, dim, hidden, dtype, rate):
    """K2f on the tensor cores (the fused kernel at dim 256, the split path
    elsewhere): within 1e-4 of the output's scale (float32) or one bf16
    rounding of the plain version, one launch, equal bits twice, and at rate
    0.1 zero exactly where K2r's mask2 drops."""
    x, params = _ffn_inputs(rows, dim, hidden, cuda, dtype)
    before = ff.launches["fused_ffn_fwd"]
    y = ff.fused_ffn(x, *params, seeds=(5, 6), rate=rate)
    p = ff.fused_ffn_fwd_plain(x, *params, seeds=(5, 6), rate=rate)
    torch.cuda.synchronize()
    assert ff.launches["fused_ffn_fwd"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    tol = _bf16_tol(p) if dtype == torch.bfloat16 else 1e-4 * p.abs().max().item()
    assert _max_err(y, p) <= tol
    assert torch.equal(y, ff.fused_ffn(x, *params, seeds=(5, 6), rate=rate))  # deterministic
    if ff.fused_widths(dim, hidden, forward=True):
        assert 0 < ff.fwd_smem_bytes(dim, dtype) <= _build.SMEM_LIMIT
    if rate:
        _, m2 = ff.fused_ffn_bits(rows, dim, hidden, (5, 6), cuda)
        assert torch.equal(y == 0, m2 >= keep_threshold(rate))


def test_fused_ffn_kernel_rejects_what_it_does_not_take(cuda):
    x, params = _ffn_inputs(8, 64, 96, cuda, torch.float32)
    with torch.no_grad():
        assert ff.fused_ffn(x, *params).shape == x.shape
    with pytest.raises(ValueError):
        ff.fused_ffn_bwd(x, *params[:5], torch.zeros(8, 32, device=cuda))  # dy shape
    with pytest.raises(ValueError):
        ff.fused_ffn_bwd(x, *params[:5], torch.zeros_like(x).cpu())  # dy on the CPU
    with pytest.raises(ValueError):
        ff.fused_ffn(x.t(), *params)  # not contiguous
    with pytest.raises(TypeError):
        ff.fused_ffn(x.half(), *params)  # another dtype


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------


# bf16 runs on the tensor cores with N padded to 16-row tiles: N around the
# tiles, every head width, an odd batch
RAGGED_N = (15, 16, 17, 37, 197, 198, 199)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,num_special,dim_head,dtype", [
    (256, 198, 2, 32, torch.bfloat16),  # shared-patch-stream minibatch
    (64, 197, 0, 32, torch.bfloat16),   # exact stacked mode, an eighth of a minibatch
    (3, 37, 2, 16, torch.float32),
    (2, 70, 0, 64, torch.bfloat16),
    (2, 198, 2, 32, torch.float32),
] + [(3, n, ns, dh, torch.bfloat16) for n in RAGGED_N for dh in (16, 32, 64)
     for ns in (0, 2)])
def test_flash_qkv_bwd_kernel_matches_plain(cuda, b, n, num_special, dim_head, dtype, rate):
    heads, seeds = 8, (123, 456)
    x = _qkv(b, n, heads, dim_head, cuda, dtype)
    do = torch.randn(b, n, heads * dim_head,
                     generator=torch.Generator().manual_seed(7)).to(cuda, dtype)
    args = (heads, dim_head, dim_head ** -0.5, num_special, seeds, rate)
    _, lse = fq.flash_qkv_fwd(x, *args)
    key = fq.bwd_kernel(n, dim_head, dtype)
    before = fq.launches[key]
    d = fq.flash_qkv_bwd(x, lse, do, *args)
    p = fq.flash_qkv_bwd_plain(x, lse, do, *args)
    torch.cuda.synchronize()
    assert fq.launches[key] == before + 1
    assert d.dtype == dtype and d.shape == x.shape
    tol = _bf16_tol(p) if dtype == torch.bfloat16 else 1e-4 * p.abs().max().item()
    assert _max_err(d, p) <= tol
    assert torch.equal(d, fq.flash_qkv_bwd(x, lse, do, *args))  # deterministic


K2B_NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,hidden", [
    (256 * 198, 256, 1024),  # shared-patch-stream minibatch
    (37, 64, 96),            # fewer rows than one tile and a half
    (130, 32, 64),
    (1000, 256, 512),
    (1001, 128, 384),        # rows that neither row tile (64, 32) divides
    (8 * 198, 256, 1024),    # the gradient check's 8 frames
    (37, 40, 100),           # ragged widths: the split path
    (37, 37, 100),           # dim % 4 != 0
    (1000, 384, 1536),
    (512, 768, 3072),
    (256, 1024, 4096),
    (256, 1280, 5120),
    (37, 1031, 100),
])
def test_fused_ffn_bwd_kernel_matches_plain(cuda, rows, dim, hidden, dtype, rate):
    x, params = _ffn_inputs(rows, dim, hidden, cuda, dtype)
    dy = torch.randn(rows, dim, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    before = ff.launches["fused_ffn_bwd"]
    out = ff.fused_ffn_bwd(x, *params[:5], dy, (5, 6), rate)
    plain = ff.fused_ffn_bwd_plain(x, *params[:5], dy, (5, 6), rate)
    torch.cuda.synchronize()
    assert ff.launches["fused_ffn_bwd"] == before + 1
    assert out[0].dtype == dtype and all(t.dtype == torch.float32 for t in out[1:])
    for name, a, p in zip(K2B_NAMES, out, plain):
        assert a.shape == p.shape, name
        if dtype == torch.float32:
            tol = 1e-4
        else:
            tol = 1.2e-2 if name == "dx" else 2e-3
        assert _max_err(a, p) <= tol * p.float().abs().max().item(), name
    again = ff.fused_ffn_bwd(x, *params[:5], dy, (5, 6), rate)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # deterministic


@pytest.mark.parametrize("num_special", [0, 2])
def test_flash_qkv_function_matches_autograd_of_plain_forward(cuda, num_special):
    heads, dh, seeds, rate = 4, 16, (9, 10), 0.1
    x = _qkv(3, 45, heads, dh, cuda, torch.float32)
    do = torch.randn(3, 45, heads * dh, generator=torch.Generator().manual_seed(1)).to(cuda)
    ref_in = x.clone().requires_grad_()
    o, _ = fq.flash_qkv_fwd_plain(ref_in, heads, dh, dh ** -0.5, num_special, seeds, rate)
    o.backward(do)
    mine = x.clone().requires_grad_()
    before = dict(fq.launches)
    fq.flash_mha_qkv(mine, heads, dh, seeds=seeds, rate=rate,
                     num_special=num_special).backward(do)
    for key in (fq.fwd_kernel(45, dh, torch.float32), fq.bwd_kernel(45, dh, torch.float32)):
        assert fq.launches[key] == before[key] + 1
    assert _max_err(mine.grad, ref_in.grad) <= 1e-4 * ref_in.grad.abs().max().item()


@pytest.mark.parametrize("dim,hidden", [(64, 96), (40, 100), (37, 100), (768, 3072)])
def test_fused_ffn_function_matches_autograd_of_plain_forward(cuda, dim, hidden):
    x, params = _ffn_inputs(130, dim, hidden, cuda, torch.float32)
    dy = torch.randn(130, dim, generator=torch.Generator().manual_seed(2)).to(cuda)
    ref_in = [t.clone().requires_grad_() for t in (x, *params)]
    ff.fused_ffn_fwd_plain(*ref_in, (5, 6), 0.1).backward(dy)
    mine = [t.clone().requires_grad_() for t in (x, *params)]
    before = dict(ff.launches)
    ff.fused_ffn(mine[0].reshape(2, 65, dim), *mine[1:], seeds=(5, 6),
                 rate=0.1).backward(dy.reshape(2, 65, dim))
    assert ff.launches["fused_ffn_fwd"] == before["fused_ffn_fwd"] + 1
    assert ff.launches["fused_ffn_bwd"] == before["fused_ffn_bwd"] + 1
    for a, b in zip(mine, ref_in):
        assert _max_err(a.grad, b.grad) <= 1e-4 * b.grad.abs().max().item()
    # only what needs a gradient gets one
    only_x = [x.clone().requires_grad_(), *params]
    ff.fused_ffn(*only_x).sum().backward()
    assert only_x[0].grad is not None and all(p.grad is None for p in only_x[1:])


def test_backward_runs_on_the_current_stream(cuda):
    """The launch takes the stream current at the call, also on autograd's
    thread inside a ``torch.cuda.stream`` block."""
    x, params = _ffn_inputs(64, 64, 96, cuda, torch.float32)
    ref = [t.clone().requires_grad_() for t in (x, *params)]
    ff.fused_ffn(*ref).square().sum().backward()
    side = torch.cuda.Stream()
    mine = [t.clone().requires_grad_() for t in (x, *params)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ff.fused_ffn(*mine).square().sum().backward()
    side.synchronize()
    for a, b in zip(mine, ref):
        assert torch.equal(a.grad, b.grad)


def test_kernel_keep_rate(cuda):
    # 4 sigma of a binomial keep count at rate 0.1
    thresh = keep_threshold(0.1)
    m1, _ = ff.fused_ffn_bits(4096, 256, 1024, (1, 2), cuda)
    keep = (m1 < thresh).double().mean().item()
    p = thresh / (1 << 24)
    assert abs(keep - p) < 4 * np.sqrt(p * (1 - p) / m1.numel())


# ---------------------------------------------------------------------------
# K4 (ops/flash) and K3 (ops/flash_dropout): [B, H, N, Dh] flash attention
# ---------------------------------------------------------------------------


def _heads(b, h, n, dh, device, dtype, count=4, seed=0):
    g = torch.Generator().manual_seed(seed * 1000 + n * 10 + dh)
    return [torch.randn(b, h, n, dh, generator=g).to(device, dtype) for _ in range(count)]


def _tol(ref, dtype):
    if dtype == torch.bfloat16:
        return _bf16_tol(ref)
    return 1e-4 * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", [15, 16, 17, 37, 197, 198, 199])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("path", ["auto", "stream"])
def test_flash_kernels_match_plain(cuda, path, rate, n, num_special, dim_head, dtype):
    """K4f / K4b at rate 0, K3f / K3b at rate 0.1, forward and backward; the
    backward by shape (``auto``) and on the streaming kernel (``stream``)."""
    q, k, v, do = _heads(2, 3, n, dim_head, cuda, dtype)
    scale, seeds = dim_head ** -0.5, (31, 41)
    choice = None if path == "auto" else "stream"
    if rate:
        fwd = lambda: fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, num_special)  # noqa: E731
        o, lse = fwd()
        po, plse = fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, num_special)
        bwd = lambda: fd.flash_dropout_bwd(q, k, v, lse, do, seeds, rate, scale,  # noqa: E731
                                           num_special, kernel=choice)
        plain = fd.flash_dropout_bwd_plain(q, k, v, lse, do, seeds, rate, scale, num_special)
        count, name = fd.launches, fd.bwd_kernel(n, dim_head, dtype)
    else:
        o, lse = fl.flash_fwd(q, k, v, scale, num_special)
        po, plse = fl.flash_fwd_plain(q, k, v, scale, num_special)
        bwd = lambda: fl.flash_bwd(q, k, v, o, lse, do, scale, num_special,  # noqa: E731
                                   kernel=choice)
        plain = fl.flash_bwd_plain(q, k, v, o, lse, do, scale, num_special)
        count, name = fl.launches, fl.bwd_kernel(n, dim_head, dtype)
    if choice:
        name = name.removesuffix("_stream") + "_stream"
    before = count[name]
    grads = bwd()
    torch.cuda.synchronize()
    assert count[name] == before + 1
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == q.shape[:3]
    assert _max_err(o, po) <= _tol(po, dtype)
    assert _max_err(lse, plse) <= 1e-4
    for a, p in zip(grads, plain):
        assert a.dtype == dtype and a.shape == q.shape
        assert _max_err(a, p) <= _tol(p, dtype)
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd()))  # deterministic


def test_flash_dropout_bits_match_plain_bit_for_bit(cuda):
    seeds = (0xDEADBEEF, 0x12345678)
    before = fd.launches["flash_dropout_bits"]
    bits = fd.dropout_raw_bits(3, 8, 198, seeds, cuda)
    assert fd.launches["flash_dropout_bits"] == before + 1
    assert torch.equal(bits, fd.dropout_raw_bits_plain(3, 8, 198, seeds, cuda))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("num_special", [0, 2])
def test_flash_functions_match_autograd_of_plain_forward(cuda, num_special, rate):
    q, k, v, do = _heads(3, 4, 45, 16, cuda, torch.float32, seed=1)
    seeds, scale = (9, 10), 16 ** -0.5
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    if rate:
        o, _ = fd.flash_dropout_fwd_plain(*ref_in, seeds, rate, scale, num_special)
    else:
        o, _ = fl.flash_fwd_plain(*ref_in, scale, num_special)
    o.backward(do)
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    before = {**fl.launches, **fd.launches}
    fd.flash_attention_dropout(*mine, seeds, rate, num_special=num_special).backward(do)
    after = {**fl.launches, **fd.launches}
    names = (("flash_dropout_fwd", fd.bwd_kernel(45, 16, torch.float32)) if rate
             else ("flash_fwd", fl.bwd_kernel(45, 16, torch.float32)))
    assert all(after[n] == before[n] + 1 for n in names)
    for a, b in zip(mine, ref_in):
        assert _max_err(a.grad, b.grad) <= 1e-4 * b.grad.abs().max().item()


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _heads(2, 2, 9, 32, cuda, torch.float32)
    with pytest.raises(TypeError):
        fl.flash_fwd(q.half(), k.half(), v.half(), 0.2)  # another dtype
    with pytest.raises(ValueError):
        fl.flash_fwd(q, k.bfloat16(), v, 0.2)  # mixed dtypes
    with pytest.raises(ValueError):
        fd.flash_dropout_fwd(q.transpose(1, 2), k, v, (1, 2), 0.1, 0.2)  # not contiguous
    wide = torch.zeros(2, 2, 9, 136, device=cuda)
    with pytest.raises(ValueError, match="dim_head 136"):
        fl.flash_fwd(wide, wide, wide, 0.2)  # no kernel takes dim_head > 128
    o, lse = fl.flash_fwd(q, k, v, 0.2)
    with pytest.raises(ValueError):
        fl.flash_bwd(q, k, v, o, lse[:, :1].contiguous(), do, 0.2)  # lse of another shape
    with pytest.raises(ValueError):
        fd.flash_dropout_bwd(q, k, v, lse, do.cpu(), (1, 2), 0.1, 0.2)  # dO on the CPU


def test_flash_backward_runs_on_the_current_stream(cuda):
    q, k, v = _heads(2, 2, 40, 32, cuda, torch.float32, count=3, seed=2)

    def grads(rate):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fd.flash_attention_dropout(*leaves, (3, 4), rate).square().sum().backward()
        return [t.grad for t in leaves]

    for rate in (0.0, 0.1):
        ref = grads(rate)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mine = grads(rate)
        side.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(mine, ref))


# ---------------------------------------------------------------------------
# K5 (ops/flash_stream): KV-streaming flash attention, any N
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", [37, 197, 198, 443, 640])
def test_flash_stream_kernels_match_plain(cuda, n, num_special, dim_head, dtype):
    """K5f, K5q and K5kv against their plain versions; the backward kernels
    twice for equal bits."""
    q, k, v, do = _heads(2, 3, n, dim_head, cuda, dtype, seed=3)
    scale = dim_head ** -0.5
    before = dict(fs.launches)
    o, lse = fs.flash_stream_fwd(q, k, v, scale, num_special)
    po, plse = fs.flash_stream_fwd_plain(q, k, v, scale, num_special)
    delta = fs.stream_delta(o, do)
    args = (q, k, v, lse, delta, do, scale, num_special)
    grads = fs.flash_stream_bwd(*args)
    plain = fs.flash_stream_bwd_plain(*args)
    torch.cuda.synchronize()
    assert {n_: fs.launches[n_] - before[n_] for n_ in fs.launches} == {
        "flash_stream_fwd": 1, "flash_stream_dq": 1, "flash_stream_dkv": 1}
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == q.shape[:3]
    assert _max_err(o, po) <= _tol(po, dtype)
    assert _max_err(lse, plse) <= 1e-4
    for a, p in zip(grads, plain):
        assert a.dtype == dtype and a.shape == q.shape
        assert _max_err(a, p) <= _tol(p, dtype)
    o2, lse2 = fs.flash_stream_fwd(q, k, v, scale, num_special)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # deterministic
    assert all(torch.equal(a, b) for a, b in zip(grads, fs.flash_stream_bwd(*args)))


@pytest.mark.parametrize("num_special", [0, 2])
def test_flash_stream_function_matches_autograd_of_plain_forward(cuda, num_special):
    q, k, v, do = _heads(3, 4, 150, 16, cuda, torch.float32, seed=4)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    fs.flash_stream_fwd_plain(*ref_in, 0.25, num_special)[0].backward(do)
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fs.launches)
    fs.flash_attention_stream(*mine, scale=0.25, num_special=num_special).backward(do)
    assert all(fs.launches[n] == before[n] + 1 for n in fs.launches)
    for a, b in zip(mine, ref_in):
        assert _max_err(a.grad, b.grad) <= 1e-4 * b.grad.abs().max().item()


def test_flash_stream_kernels_reject_what_they_do_not_take(cuda):
    from eavit_tpu_torch.ops.attention import mha

    q, k, v, do = _heads(2, 2, 9, 32, cuda, torch.float32)
    with pytest.raises(TypeError):
        fs.flash_stream_fwd(q.half(), k.half(), v.half(), 0.2)  # another dtype
    with pytest.raises(ValueError):
        fs.flash_stream_fwd(q, k.bfloat16(), v, 0.2)  # mixed dtypes
    with pytest.raises(ValueError):
        fs.flash_stream_fwd(q.transpose(1, 2), k, v, 0.2)  # not contiguous
    wide = torch.zeros(2, 2, 9, 136, device=cuda)
    with pytest.raises(ValueError, match="dim_head 136"):
        fs.flash_stream_fwd(wide, wide, wide, 0.2)  # no kernel takes dim_head > 128
    o, lse = fs.flash_stream_fwd(q, k, v, 0.2)
    delta = fs.stream_delta(o, do)
    with pytest.raises(ValueError):
        fs.flash_stream_dq(q, k, v, lse[:, :1].contiguous(), delta, do, 0.2)  # lse shape
    with pytest.raises(ValueError):
        fs.flash_stream_dkv(q, k, v, lse, delta.double(), do, 0.2)  # delta not f32
    with pytest.raises(ValueError):
        fs.flash_stream_dkv(q, k, v, lse, delta, do.cpu(), 0.2)  # dO on the CPU
    with pytest.raises(ValueError, match="pallas_stream"):
        mha(q, k, v, impl="pallas_stream", dropout_rate=0.1)  # no probability dropout


def test_flash_stream_shared_memory_does_not_grow_with_n(cuda):
    """Each K5 kernel's shared memory is a function of Dh and the dtype
    alone, within one block's limit (the bf16 K5q and K5kv pass 48 KB at Dh
    64 and opt in); the kernels launch at N = 3,137."""
    for dtype in (torch.bfloat16, torch.float32):
        for dh in (16, 32, 64, 128):
            sizes = {name: fs.smem_bytes(name, dh, dtype) for name in ("fwd", "dq", "dkv")}
            assert all(0 < b <= _build.SMEM_LIMIT for b in sizes.values()), (dtype, sizes)
    q, k, v, do = _heads(1, 2, 3137, 64, cuda, torch.bfloat16, seed=5)
    o, lse = fs.flash_stream_fwd(q, k, v, 0.125)
    dq, dk, dv = fs.flash_stream_bwd(q, k, v, lse, fs.stream_delta(o, do), do, 0.125)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.float()).all() for t in (o, lse, dq, dk, dv))


@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", (198, 443, 3137))
def test_bf16_flash_stream_forward_kernel_matches_plain(cuda, n, num_special, dim_head):
    """The bf16 K5f, the one-sweep mode of the tensor-core forward: one launch,
    o within one bf16 rounding of the plain version and lse within 1e-4,
    equal bits twice, and shared memory that N does not change (the bytes of
    the same template's K4f, read before and after the launch)."""
    b, h = (2, 3) if n <= 443 else (1, 2)
    q, k, v = _heads(b, h, n, dim_head, cuda, torch.bfloat16, count=3, seed=9)
    scale = dim_head ** -0.5
    smem = fs.smem_bytes("fwd", dim_head, torch.bfloat16)
    assert smem == fl.fwd_smem(dim_head, torch.bfloat16)
    before = fs.launches["flash_stream_fwd"]
    o, lse = fs.flash_stream_fwd(q, k, v, scale, num_special)
    po, plse = fs.flash_stream_fwd_plain(q, k, v, scale, num_special)
    torch.cuda.synchronize()
    assert fs.launches["flash_stream_fwd"] == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and lse.shape == q.shape[:3]
    assert _max_err(o, po) <= _bf16_tol(po)
    assert _max_err(lse, plse) <= 1e-4
    o2, lse2 = fs.flash_stream_fwd(q, k, v, scale, num_special)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # deterministic
    assert fs.smem_bytes("fwd", dim_head, torch.bfloat16) == smem


# ---------------------------------------------------------------------------
# K5q and K5kv in bf16: the dq and the dk/dv kernel of csrc/attn_bwd_mma.cuh,
# each launched alone, with the caller's delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", (11, 197, 198, 443, 640, 3137))
def test_bf16_flash_stream_backward_kernels_match_plain(cuda, n, num_special, dim_head):
    """K5kv first, on a fresh delta, then K5q, each called alone: one launch
    each, within one bf16 rounding of the plain version, equal bits twice,
    and delta bit for bit as it was (neither kernel writes it)."""
    b, h = (2, 3) if n <= 640 else (1, 2)
    q, k, v, do = _heads(b, h, n, dim_head, cuda, torch.bfloat16, seed=8)
    scale = dim_head ** -0.5
    o, lse = fs.flash_stream_fwd_plain(q, k, v, scale, num_special)
    delta = fs.stream_delta(o, do)
    fresh = delta.clone()
    args = (q, k, v, lse, delta, do, scale, num_special)
    before = dict(fs.launches)
    dk, dv = fs.flash_stream_dkv(*args)
    dq = fs.flash_stream_dq(*args)
    torch.cuda.synchronize()
    assert {n_: fs.launches[n_] - before[n_] for n_ in fs.launches} == {
        "flash_stream_fwd": 0, "flash_stream_dq": 1, "flash_stream_dkv": 1}
    assert torch.equal(delta, fresh)
    plain = (fs.flash_stream_dq_plain(*args),) + fs.flash_stream_dkv_plain(*args)
    for a, p in zip((dq, dk, dv), plain):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        assert _max_err(a, p) <= _bf16_tol(p)
    assert torch.equal(dq, fs.flash_stream_dq(*args))  # deterministic
    assert all(torch.equal(a, b_) for a, b_ in zip((dk, dv), fs.flash_stream_dkv(*args)))
    assert torch.equal(delta, fresh)


def test_bf16_flash_stream_backward_keeps_a_cancelling_dq(cuda):
    """K5q keeps p and ds in float32 (two bf16 terms each): on keys that make
    dq nearly cancel, its dq errs at most a tenth as much as the dq of the
    plain formulas with ds rounded to bf16 before ``ds k``."""
    b, h, n, dh, ns = 2, 4, 198, 32, 2
    q, k, v, do = _cancelling_heads(b, h, n, dh, cuda)
    scale = dh ** -0.5
    o, lse = fs.flash_stream_fwd(q, k, v, scale, ns)
    delta = fs.stream_delta(o, do)
    dq = fs.flash_stream_dq(q, k, v, lse, delta, do, scale, ns)
    _, ds = fs._probs_and_ds(q, k, v, lse, delta, do, scale, ns)
    dq_plain = torch.matmul(ds, k.float()).to(torch.bfloat16).float()
    dq_rounded = torch.matmul(ds.to(torch.bfloat16).float(), k.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    err, err_rounded = _max_err(dq, dq_plain), _max_err(dq_rounded, dq_plain)
    assert err_rounded > 0 and err <= 0.1 * err_rounded, (err, err_rounded)


@pytest.mark.parametrize("num_special", [0, 2])
def test_bf16_flash_stream_function_matches_autograd_of_plain_forward(cuda, num_special):
    """bf16 through the Function (K5f, then K5q and K5kv) against autograd of
    the plain forward, at one bf16 rounding of each gradient: the kernels
    take delta from the rounded O, autograd from the unrounded one."""
    q, k, v, do = _heads(3, 4, 150, 32, cuda, torch.bfloat16, seed=9)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    fs.flash_stream_fwd_plain(*ref_in, 0.25, num_special)[0].backward(do)
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fs.launches)
    fs.flash_attention_stream(*mine, scale=0.25, num_special=num_special).backward(do)
    torch.cuda.synchronize()
    assert all(fs.launches[n] == before[n] + 1 for n in fs.launches)
    for a, b in zip(mine, ref_in):
        assert a.grad.dtype == torch.bfloat16
        assert _max_err(a.grad, b.grad) <= _bf16_tol(b.grad)


def test_bf16_flash_stream_backward_refuses_unaligned_operands(cuda):
    """The tensor-core K5q and K5kv copy 16-byte rows: a bf16 operand that
    does not start on a 16-byte boundary raises before any launch."""
    q, k, v, do = _heads(1, 2, 40, 32, cuda, torch.bfloat16, seed=10)
    o, lse = fs.flash_stream_fwd_plain(q, k, v, 0.2)
    delta = fs.stream_delta(o, do)
    shifted = torch.empty(q.numel() + 8, device=cuda, dtype=torch.bfloat16)[1:q.numel() + 1]
    shifted = shifted.view(q.shape).copy_(q)  # contiguous, 2 bytes past a boundary
    before = dict(fs.launches)
    for bad in ((shifted, k, v, lse, delta, do), (q, k, v, lse, delta, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            fs.flash_stream_dq(*bad, 0.2)
        with pytest.raises(ValueError, match="16-byte"):
            fs.flash_stream_dkv(*bad, 0.2)
    assert fs.launches == before


# ---------------------------------------------------------------------------
# K1b and K3b in bf16: the tensor-core kernels of csrc/attn_bwd_mma.cuh
# ---------------------------------------------------------------------------

def _cancelling_heads(b, h, n, dh, device):
    """q, k, v, dO [B, H, N, Dh] in bf16 with keys 8 + 0.01 noise: every key
    is nearly the same, so dq = sum_j ds_ij k_j, whose ds_ij sum to 0 over j,
    nearly cancels."""
    rng = np.random.default_rng(12)
    q, v, do, noise = (rng.standard_normal((b, h, n, dh)).astype(np.float32)
                       for _ in range(4))
    k = 8.0 + 0.01 * noise
    return [torch.from_numpy(t).to(device, torch.bfloat16) for t in (q, k, v, do)]


def _merged(t):
    """[B, H, N, Dh] -> [B, N, H*Dh]"""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


@pytest.mark.parametrize("choice", ["head", "stream"])
def test_bf16_backward_keeps_a_cancelling_dq(cuda, choice):
    """K3b keeps pd and ds in float32 (as two bf16 terms each): its dq error
    against the plain version is at most a tenth of the error of the dq that
    rounding ds to bf16 gives. That rounded dq is the plain K1b on the same
    inputs (K1 rounds pd and ds, and draws the same mask), which the K1b
    kernel itself must match at one bf16 rounding; both kernels of each."""
    b, h, n, dh, ns = 2, 4, 198, 32, 2
    q, k, v, do = _cancelling_heads(b, h, n, dh, cuda)
    scale, seeds, rate = dh ** -0.5, (5, 9), 0.1
    _, lse = fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns)
    dq = fd.flash_dropout_bwd(q, k, v, lse, do, seeds, rate, scale, ns, kernel=choice)[0]
    dq_plain = fd.flash_dropout_bwd_plain(q, k, v, lse, do, seeds, rate, scale, ns)[0]
    qkv = torch.cat([_merged(t) for t in (q, k, v)], dim=-1).contiguous()
    args = (h, dh, scale, ns, seeds, rate)
    rounded = fq.flash_qkv_bwd_plain(qkv, lse, _merged(do).contiguous(), *args)
    dq_rounded = rounded[..., :h * dh].reshape(b, n, h, dh).transpose(1, 2)
    torch.cuda.synchronize()
    err, err_rounded = _max_err(dq, dq_plain), _max_err(dq_rounded, dq_plain)
    assert err_rounded > 0 and err <= 0.1 * err_rounded, (err, err_rounded)
    d1 = fq.flash_qkv_bwd(qkv, lse, _merged(do).contiguous(), *args, kernel=choice)
    assert _max_err(d1, rounded) <= _bf16_tol(rounded)


@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("dim_head", [16, 32])
def test_bf16_backward_kernels_take_patch4_sequences(cuda, dim_head, num_special):
    """N = 443 (patch 4): the bf16 K1b and K3b take it, matching their plain
    versions with equal bits twice."""
    b, h, n, seeds, rate = 3, 2, 443, (8, 9), 0.1
    scale = dim_head ** -0.5
    q, k, v, do = _heads(b, h, n, dim_head, cuda, torch.bfloat16, seed=7)
    qkv = torch.cat([_merged(t) for t in (q, k, v)], dim=-1).contiguous()
    g = _merged(do).contiguous()
    args = (h, dim_head, scale, num_special, seeds, rate)
    _, lse = fq.flash_qkv_fwd(qkv, *args)
    d = fq.flash_qkv_bwd(qkv, lse, g, *args)
    p = fq.flash_qkv_bwd_plain(qkv, lse, g, *args)
    assert _max_err(d, p) <= _bf16_tol(p)
    assert torch.equal(d, fq.flash_qkv_bwd(qkv, lse, g, *args))
    _, lse = fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, num_special)
    bargs = (q, k, v, lse, do, seeds, rate, scale, num_special)
    grads, plain = fd.flash_dropout_bwd(*bargs), fd.flash_dropout_bwd_plain(*bargs)
    for a, r in zip(grads, plain):
        assert _max_err(a, r) <= _bf16_tol(r)
    assert all(torch.equal(a, r) for a, r in zip(grads, fd.flash_dropout_bwd(*bargs)))


# ---------------------------------------------------------------------------
# the tensor-core K1f (attn_fwd_mma.cuh) and K4b (attn_bwd_mma.cuh, delta from
# O), and each kernel's limit on N
# ---------------------------------------------------------------------------

MMA_N = (11, 197, 198, 443)


@pytest.mark.parametrize("path", ["head", "stream"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", MMA_N)
def test_bf16_flash_qkv_forward_kernel_matches_plain(cuda, n, num_special, dim_head, rate,
                                                     path):
    """sigma' is rounded to bf16 after normalisation and dropout, as
    ``_head_fwd`` rounds it: o within one bf16 rounding, lse within 1e-4;
    the whole-head and the streaming kernel."""
    heads, seeds = 2, (123, 456)
    x = _qkv(3, n, heads, dim_head, cuda, torch.bfloat16)
    args = (heads, dim_head, dim_head ** -0.5, num_special, seeds, rate)
    key = "flash_qkv_fwd" if path == "head" else "flash_qkv_fwd_stream"
    before = fq.launches[key]
    o, lse = fq.flash_qkv_fwd(x, *args, kernel=path)
    po, plse = fq.flash_qkv_fwd_plain(x, *args)
    torch.cuda.synchronize()
    assert fq.launches[key] == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == (3, n, heads * dim_head)
    assert _max_err(o, po) <= _bf16_tol(po)
    assert _max_err(lse, plse) <= 1e-4
    o2, lse2 = fq.flash_qkv_fwd(x, *args, kernel=path)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # deterministic


@pytest.mark.parametrize("path", ["auto", "stream"])
@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", MMA_N)
def test_bf16_flash_backward_kernel_matches_plain(cuda, n, num_special, dim_head, path):
    """K4b on the tensor cores: p and ds as two bf16 terms each, delta =
    sum(dO * O) from the forward's O; one bf16 rounding of each output; the
    kernel the shape picks and the streaming one."""
    q, k, v, do = _heads(3, 2, n, dim_head, cuda, torch.bfloat16, seed=3)
    scale = dim_head ** -0.5
    choice = None if path == "auto" else "stream"
    o, lse = fl.flash_fwd_plain(q, k, v, scale, num_special)
    key = fl.bwd_kernel(n, dim_head, torch.bfloat16) if choice is None else "flash_bwd_stream"
    before = fl.launches[key]
    grads = fl.flash_bwd(q, k, v, o, lse, do, scale, num_special, kernel=choice)
    plain = fl.flash_bwd_plain(q, k, v, o, lse, do, scale, num_special)
    torch.cuda.synchronize()
    assert fl.launches[key] == before + 1
    for a, p in zip(grads, plain):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        assert _max_err(a, p) <= _bf16_tol(p)
    again = fl.flash_bwd(q, k, v, o, lse, do, scale, num_special, kernel=choice)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # deterministic


def _calls(kernel, n, dh, h, dtype, device, ns=2, choice=None, rate=0.1):
    """``(kernel call, plain call)`` of one wrapper at ``[1, h, n, dh]``, each
    returning a tuple of outputs (lse last for a forward); ``choice`` goes to
    the ``kernel`` argument of the wrappers that have one, ``rate`` to K1's
    and K3's."""
    seeds = (3, 5)
    scale = dh ** -0.5
    q, k, v, do = _heads(1, h, n, dh, device, dtype, seed=4)
    if kernel.startswith("flash_qkv"):
        qkv = torch.cat([_merged(t) for t in (q, k, v)], dim=-1).contiguous()
        g = _merged(do).contiguous()
        args = (h, dh, scale, ns, seeds, rate)
        lse = fq.flash_qkv_fwd_plain(qkv, *args)[1]
        return {
            "flash_qkv_fwd": (lambda: fq.flash_qkv_fwd(qkv, *args, kernel=choice),
                              lambda: fq.flash_qkv_fwd_plain(qkv, *args)),
            "flash_qkv_bwd": (lambda: (fq.flash_qkv_bwd(qkv, lse, g, *args, kernel=choice),),
                              lambda: (fq.flash_qkv_bwd_plain(qkv, lse, g, *args),)),
        }[kernel]
    if kernel.startswith("flash_dropout"):
        lse = fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, ns)[1]
        bargs = (q, k, v, lse, do, seeds, rate, scale, ns)
        return {
            "flash_dropout_fwd": (lambda: fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns),
                                  lambda: fd.flash_dropout_fwd_plain(q, k, v, seeds, rate,
                                                                     scale, ns)),
            "flash_dropout_bwd": (lambda: fd.flash_dropout_bwd(*bargs, kernel=choice),
                                  lambda: fd.flash_dropout_bwd_plain(*bargs)),
        }[kernel]
    o, lse = fl.flash_fwd_plain(q, k, v, scale, ns)
    return {
        "flash_fwd": (lambda: fl.flash_fwd(q, k, v, scale, ns),
                      lambda: fl.flash_fwd_plain(q, k, v, scale, ns)),
        "flash_bwd": (lambda: fl.flash_bwd(q, k, v, o, lse, do, scale, ns, kernel=choice),
                      lambda: fl.flash_bwd_plain(q, k, v, o, lse, do, scale, ns)),
    }[kernel]


# ---------------------------------------------------------------------------
# K1, K3 and K4 stream their operands: any N
# ---------------------------------------------------------------------------

ATTENTION_KERNELS = ("flash_qkv_fwd", "flash_qkv_bwd", "flash_fwd", "flash_bwd",
                     "flash_dropout_fwd", "flash_dropout_bwd")


def _module(kernel):
    return {"flash_qkv": fq, "flash": fl, "flash_dropout": fd}[kernel.rsplit("_", 1)[0]]


def _key(kernel, n, dim_head, dtype, choice):
    """The ``launches`` key of a call of ``kernel`` with ``kernel=choice``."""
    mod = _module(kernel)
    picked = getattr(mod, "fwd_kernel" if kernel.endswith("fwd") else "bwd_kernel", None)
    if picked is None:  # K3f, K4f: one kernel
        return kernel
    return picked(n, dim_head, dtype) if choice is None else kernel + "_stream"


@pytest.mark.parametrize("path", ["auto", "stream"])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("n", [37, 198, 443, 786, 1766])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ATTENTION_KERNELS)
def test_attention_kernels_take_any_n(cuda, kernel, dtype, n, dim_head, num_special, path):
    """Every function of K1, K3 and K4 in both dtypes, at the sequences of
    patch 4, 3 and 2 and at 37 and 198: by shape (``auto``: the whole-head
    bf16 kernel where it fits) and on the streaming kernel (``stream``), one
    launch per call under the kernel's own key, within one bf16 rounding
    (bf16) or 1e-4 of scale (float32) of the plain version, lse within 1e-4,
    equal bits twice."""
    mod = _module(kernel)
    choice = None if path == "auto" else "stream"
    call, plain = _calls(kernel, n, dim_head, 2, dtype, cuda, ns=num_special, choice=choice)
    key = _key(kernel, n, dim_head, dtype, choice)
    before = mod.launches[key]
    got = call()
    want = plain()
    torch.cuda.synchronize()
    assert mod.launches[key] == before + 1
    outs = got[:-1] if kernel.endswith("fwd") else got
    refs = want[:-1] if kernel.endswith("fwd") else want
    for a, p in zip(outs, refs):
        assert a.dtype == dtype
        assert _max_err(a, p) <= _tol(p, dtype)
    if kernel.endswith("fwd"):
        assert _max_err(got[-1], want[-1]) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, call()))  # deterministic


def test_attention_shared_memory_does_not_grow_with_n(cuda):
    """Each kernel's shared memory is a function of Dh and the dtype alone,
    within one block's limit; every kernel launches at N = 3,137."""
    for dtype in (torch.bfloat16, torch.float32):
        for dh in (16, 32, 64, 128):
            sizes = [fq.fwd_smem(dh, dtype), *fq.bwd_smem(dh, dtype), fl.fwd_smem(dh, dtype),
                     *fl.bwd_smem(dh, dtype), fd.fwd_smem(dh, dtype), *fd.bwd_smem(dh, dtype)]
            assert all(0 < b <= _build.SMEM_LIMIT for b in sizes), (dtype, dh, sizes)
    for kernel in ATTENTION_KERNELS:
        mod = _module(kernel)
        call, _ = _calls(kernel, 3137, 64, 1, torch.bfloat16, cuda)
        key = _key(kernel, 3137, 64, torch.bfloat16, None)
        assert key.endswith("_stream") or kernel in ("flash_fwd", "flash_dropout_fwd")
        before = mod.launches[key]
        out = call()
        torch.cuda.synchronize()
        assert mod.launches[key] == before + 1
        assert all(torch.isfinite(t.float()).all() for t in out)


@pytest.mark.parametrize("dim_head", [16, 32, 64])
@pytest.mark.parametrize("num_special", [0, 2])
@pytest.mark.parametrize("n", MMA_N)
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dropout_fwd"])
def test_bf16_flash_forward_kernels_match_plain(cuda, kernel, n, num_special, dim_head):
    """K4f (rate 0) and K3f (rate 0.1) on the tensor cores, sigma' kept f32
    as two bf16 terms: o within one bf16 rounding, lse within 1e-4, equal
    bits twice."""
    q, k, v = _heads(3, 2, n, dim_head, cuda, torch.bfloat16, count=3, seed=6)
    scale, seeds = dim_head ** -0.5, (123, 456)
    if kernel == "flash_fwd":
        call = lambda: fl.flash_fwd(q, k, v, scale, num_special)  # noqa: E731
        po, plse = fl.flash_fwd_plain(q, k, v, scale, num_special)
    else:
        call = lambda: fd.flash_dropout_fwd(q, k, v, seeds, 0.1, scale, num_special)  # noqa: E731
        po, plse = fd.flash_dropout_fwd_plain(q, k, v, seeds, 0.1, scale, num_special)
    mod = _module(kernel)
    before = mod.launches[kernel]
    o, lse = call()
    torch.cuda.synchronize()
    assert mod.launches[kernel] == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert _max_err(o, po) <= _bf16_tol(po)
    assert _max_err(lse, plse) <= 1e-4
    o2, lse2 = call()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # deterministic


@pytest.mark.parametrize("choice", ["head", "stream"])
def test_bf16_flash_backward_keeps_a_cancelling_dq(cuda, choice):
    """K4b keeps p and ds in float32 (two bf16 terms each): on keys that make
    dq nearly cancel, its dq errs at most a tenth as much as the dq of the
    same formulas with ds rounded to bf16 before ``ds k``; both kernels."""
    b, h, n, dh, ns = 2, 4, 198, 32, 2
    q, k, v, do = _cancelling_heads(b, h, n, dh, cuda)
    scale = dh ** -0.5
    o, lse = fl.flash_fwd(q, k, v, scale, ns)
    dq = fl.flash_bwd(q, k, v, o, lse, do, scale, ns, kernel=choice)[0]
    gf = do.float()
    p = torch.exp(fl.masked_scores(q, k, scale, ns) - lse[..., None])
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = p * (dp - (gf * o.float()).sum(dim=-1, keepdim=True)) * scale
    dq_plain = torch.matmul(ds, k.float()).to(torch.bfloat16).float()
    dq_rounded = torch.matmul(ds.to(torch.bfloat16).float(), k.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    err, err_rounded = _max_err(dq, dq_plain), _max_err(dq_rounded, dq_plain)
    assert err_rounded > 0 and err <= 0.1 * err_rounded, (err, err_rounded)


STREAM_KERNELS = ("flash_stream_fwd", "flash_stream_dq", "flash_stream_dkv")


def _stream_calls(kernel, n, dh, dtype, device, ns=2):
    """``(kernel call, plain call)`` of one K5 wrapper at ``[1, 2, n, dh]``."""
    q, k, v, do = _heads(1, 2, n, dh, device, dtype, seed=5)
    scale = dh ** -0.5
    o, lse = fs.flash_stream_fwd_plain(q, k, v, scale, ns)
    args = (q, k, v, lse, fs.stream_delta(o, do), do, scale, ns)
    return {
        "flash_stream_fwd": (lambda: fs.flash_stream_fwd(q, k, v, scale, ns),
                             lambda: fs.flash_stream_fwd_plain(q, k, v, scale, ns)),
        "flash_stream_dq": (lambda: (fs.flash_stream_dq(*args),),
                            lambda: (fs.flash_stream_dq_plain(*args),)),
        "flash_stream_dkv": (lambda: fs.flash_stream_dkv(*args),
                             lambda: fs.flash_stream_dkv_plain(*args)),
    }[kernel]


@pytest.mark.parametrize("n", [37, 198])
@pytest.mark.parametrize("dim_head", [8, 24, 40, 48, 60, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ATTENTION_KERNELS + STREAM_KERNELS)
def test_attention_kernels_take_every_head_width(cuda, kernel, dtype, dim_head, n):
    """Every attention function at a head width between the instantiated 16 /
    32 / 64, which it runs zero-padded to the next of them: one launch under
    the key of the kernel that ran, within one bf16 rounding (bf16) or 1e-4 of
    scale (float32) of the plain version at the true width, lse within 1e-4,
    outputs of the caller's width, equal bits twice."""
    if kernel in STREAM_KERNELS:
        mod, key = fs, kernel
        call, plain = _stream_calls(kernel, n, dim_head, dtype, cuda)
    else:
        mod, key = _module(kernel), _key(kernel, n, dim_head, dtype, None)
        call, plain = _calls(kernel, n, dim_head, 2, dtype, cuda)
    before = mod.launches[key]
    got = call()
    want = plain()
    torch.cuda.synchronize()
    assert mod.launches[key] == before + 1
    fwd = kernel.endswith("fwd")
    for a, p in zip(got[:-1] if fwd else got, want[:-1] if fwd else want):
        assert a.dtype == dtype and a.shape == p.shape
        assert _max_err(a, p) <= _tol(p, dtype)
    if fwd:
        assert _max_err(got[-1], want[-1]) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, call()))  # deterministic


# (kernel, rate): K1 at both rates, K3 at 0.1 (at rate 0 it is K4), K4 and K5 at 0
WIDE_HEAD_CASES = [(k, r) for k in ATTENTION_KERNELS + STREAM_KERNELS
                   for r in ((0.0, 0.1) if k.startswith("flash_qkv") else
                             (0.1,) if k.startswith("flash_dropout") else (0.0,))]


@pytest.mark.parametrize("n", [198, 443])
@pytest.mark.parametrize("dim_head", [96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,rate", WIDE_HEAD_CASES)
def test_attention_kernels_take_head_widths_to_128(cuda, kernel, rate, dtype, dim_head, n):
    """Every attention function at Dh 96 (zero-padded) and 128, on the
    streaming kernels whatever N is (the whole-head ones stop at 64), K1 at
    rates 0 and 0.1: one launch under the streaming key, within one
    bf16 rounding (bf16) or 1e-4 of scale (float32) of the plain version, lse
    within 1e-4, equal bits twice."""
    if kernel in STREAM_KERNELS:
        mod, key = fs, kernel
        call, plain = _stream_calls(kernel, n, dim_head, dtype, cuda)
    else:
        mod, key = _module(kernel), _key(kernel, n, dim_head, dtype, None)
        assert key == kernel or key.endswith("_stream")
        call, plain = _calls(kernel, n, dim_head, 2, dtype, cuda, rate=rate)
    before = mod.launches[key]
    got = call()
    want = plain()
    torch.cuda.synchronize()
    assert mod.launches[key] == before + 1
    fwd = kernel.endswith("fwd")
    for a, p in zip(got[:-1] if fwd else got, want[:-1] if fwd else want):
        assert a.dtype == dtype and a.shape == p.shape
        assert _max_err(a, p) <= _tol(p, dtype)
    if fwd:
        assert _max_err(got[-1], want[-1]) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, call()))  # deterministic


@pytest.mark.parametrize("attention", ["pallas_qkv", "pallas", "pallas_stream"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_network_backward_gives_every_kernel_equal_bits_twice(cuda, attention, compute_dtype):
    """The flagship network's loss and backward on 8 frames (chip_smoke's
    gradient check), twice on the same inputs with the allocator's free memory
    filled with NaN bytes before the first run and random bytes before the
    second: every kernel output the network's wrappers return has the same
    bits in both runs."""
    import chip_smoke as cs

    mods = (fq, ff, fl, fd, fs)
    agent = cs.grad_agent(torch, cuda, attention, compute_dtype)
    host = cs.host_batch(torch, 8)
    runs = []
    for fill in (0xFF, None):
        cs.poison_allocator(torch, cuda, fill)
        runs.append(cs.network_grads(torch, agent, host, mods))
    res = cs.compare_repeats(torch, runs)
    assert res["kernel_calls"] > 0 and res["kernels_differing"] == {}, res
    assert res["loss_equal"]


def test_refused_dtypes_and_head_widths_raise_at_any_length(cuda):
    """A dtype or Dh the kernels do not take raises whatever N is, before any
    launch."""
    n, before = 1000, {**fq.launches, **fl.launches, **fd.launches}
    qkv = torch.zeros(1, n, 3 * 2 * 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fq.flash_qkv_fwd(qkv, 2, 32, 0.2)
    with pytest.raises(ValueError, match="dim_head"):
        fq.flash_qkv_fwd(torch.zeros(1, n, 3 * 2 * 136, device=cuda), 2, 136, 0.2)
    q = torch.zeros(1, 2, n, 136, device=cuda)
    with pytest.raises(ValueError, match="dim_head"):
        fl.flash_fwd(q, q, q, 0.2)
    with pytest.raises(ValueError, match="dim_head"):
        fd.flash_dropout_bwd(q, q, q, torch.zeros(1, 2, n, device=cuda), q, (1, 2), 0.1, 0.2)
    assert {**fq.launches, **fl.launches, **fd.launches} == before


# ---------------------------------------------------------------------------
# continuous actions, NoisyNet and modified_RND on the card
# ---------------------------------------------------------------------------

SMALL_VIT = dict(dim=32, patch_size=21, depth=1, heads=2, dim_head=16, mlp_dim=64,
                 dropout=0.0, emb_dropout=0.0)


def _small_agents(cuda, continuous):
    """The same small agent on the card and on the CPU, NoisyNet on with one
    noise given to both (chip_smoke.freeze_noise), dropout 0, ``UpdateProportion
    = 1``: continuous actions + PPO, or discrete + ``modified_RND``."""
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, TrainMethod, ViTConfig
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.rl.agent import RNDAgent

    cfg = Config(vit=ViTConfig(**SMALL_VIT), num_env_per_process=2, num_step=8, epoch=1,
                 mini_batch=2, compute_dtype="float32", attention_impl="pallas_qkv",
                 fused_ffn=True, use_noisy_net=True, update_proportion=1.0,
                 learning_rate=1e-3, stable_eps=1e-3,
                 train_method=TrainMethod.PPO if continuous else TrainMethod.MODIFIED_RND)
    space = ActionSpaceType.CONTINUOUS if continuous else ActionSpaceType.DISCRETE
    agents = [RNDAgent(cfg, 1 if continuous else 5, space, device=d) for d in (cuda, "cpu")]
    states = [a.init_state(0) for a in agents]
    cs.freeze_noise(torch, agents, 7)
    return agents, states


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous_noisy",
                                                           "modified_rnd_noisy"])
def test_item5_agent_acts_and_updates_on_cuda_like_its_cpu_copy(cuda, continuous):
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import Rollout

    (gpu, cpu), (sg, sc) = _small_agents(cuda, continuous)
    rng = np.random.default_rng(3)
    T, N = 8, 2
    obs = rng.integers(0, 256, (T, N, 4, 84, 84), dtype=np.uint8)
    # acting: the noisy forward of the same frames (the samples come from each
    # device's own generator, so the network's outputs are compared)
    x = torch.from_numpy(obs[0]).float() / 255.0
    with torch.no_grad():
        og, oc = gpu.network(x.to(cuda), Rng(1, cuda)), cpu.network(x, Rng(1, "cpu"))
    for name in ("policy", "value_ext", "value_int"):
        assert _max_err(getattr(og, name).cpu(), getattr(oc, name)) <= 1e-4, name
    acts, _, _, pol = gpu.act(obs[0], Rng(1, cuda))
    assert acts.device == pol.device == og.policy.device and torch.isfinite(pol).all()
    if continuous:
        assert acts.shape == (N, 1) and pol.shape == (N, 1)
        actions = rng.uniform(-1, 1, (T, N, 1)).astype(np.float32)
        policy = (rng.standard_normal((T, N, 1)) - 1.0).astype(np.float32)
        next_obs = np.zeros((T, N, 1, 84, 84), np.uint8)
    else:
        actions = rng.integers(0, 5, (T, N))
        policy = rng.standard_normal((T, N, 5)).astype(np.float32)
        next_obs = rng.integers(0, 256, (T, N, 4, 84, 84), dtype=np.uint8)
        sg, sc = gpu.update_obs_rms(sg, next_obs[0]), cpu.update_obs_rms(sc, next_obs[0])
    ro = dict(states=obs, actions=actions, rewards=rng.standard_normal((T, N)).astype(
        np.float32), dones=rng.random((T, N)) < 0.2, next_obs=next_obs,
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32), policy=policy)
    perm = torch.from_numpy(rng.permutation(T * N))
    out = []
    for agent, state, dev in ((gpu, sg, cuda), (cpu, sc, "cpu")):
        agent._permutation = lambda r, n, d=dev: perm.to(d)
        rollout = Rollout(**{k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in ro.items()})
        _, metrics = agent.update(state, rollout, Rng(2, dev))
        out.append(({k: float(v) for k, v in metrics.items()},
                    [p.detach().cpu() for p in agent.trainable_parameters()]))
    (mg, pg), (mc, pc) = out
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-3 * max(1.0, abs(mc[k])), k
    assert max(_max_err(a, b) for a, b in zip(pg, pc)) <= 1e-4


def test_device_env_collect_with_noisy_net_never_syncs(cuda):
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, EnvType, ViTConfig
    from eavit_tpu_torch.envs.device_env import make_device_env
    from eavit_tpu_torch.models.layers import NoisyLinear, Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector

    cfg = Config(vit=ViTConfig(**{**SMALL_VIT, "dropout": 0.1}), num_env_per_process=4,
                 num_step=8, env_type=EnvType.SYNTHETIC_DEVICE, use_noisy_net=True,
                 attention_impl="pallas_qkv", fused_ffn=True)
    agent = RNDAgent(cfg, 5, device=cuda)
    agent.init_state(0)
    assert any(isinstance(m, NoisyLinear) for m in agent.network.modules())
    params, env_state = make_device_env(4, seed=0, device=cuda)
    collector = ScanRolloutCollector(cfg, agent, params)
    rng = Rng(0, cuda)
    _, env_state, _ = collector.collect(env_state, rng)  # warm
    assert cs.host_syncs(torch, lambda: collector.collect(env_state, rng))[1] == []


def test_k1f_and_k2f_at_the_next_obs_pass_shape(cuda):
    """The ``modified_RND`` embedding pass feeds K1f ``feature_chunk`` frames
    of 198 tokens and K2f 198 rows a frame, both at rate 0."""
    import chip_smoke as cs
    from eavit_tpu_torch.rl.agent import RNDAgent

    b, n = RNDAgent.feature_chunk, 198
    qkv = _qkv(b, n, 8, 32, cuda, torch.bfloat16)
    args = (8, 32, 32 ** -0.5, 2, (1, 2), 0.0)
    o, lse = fq.flash_qkv_fwd(qkv, *args)
    po, plse = fq.flash_qkv_fwd_plain(qkv, *args)
    assert _max_err(o, po) <= _bf16_tol(po) and _max_err(lse, plse) <= 1e-4
    del qkv, o, lse, po, plse
    params, f = cs._ffn_params(torch, cuda, 256, 1024, 5)
    x = f(b * n, 256).to(cuda)
    y = ff.fused_ffn(x, *params, seeds=(1, 2), rate=0.0)
    p = ff.fused_ffn_fwd_plain(x, *params, seeds=(1, 2), rate=0.0)
    assert _max_err(y, p) <= 1e-4 * p.abs().max().item()


@pytest.mark.parametrize("attention", ["pallas_qkv", "pallas"])
def test_remat_on_the_card_gives_the_gradient_bits_of_none(cuda, attention):
    """``EncoderRemat = full | dots`` at dropout 0.1: the recompute replays
    the first run's seed words and device draws, so the network's gradients
    keep the bits of ``none``; the forward kernels run once more a layer."""
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, ViTConfig
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.ops import flash_dropout
    from eavit_tpu_torch.rl.agent import RNDAgent

    host = cs.host_batch(torch, 6)
    grads, fwd = {}, {}
    for mode in ("none", "full", "dots"):
        cfg = Config(vit=ViTConfig(**{**SMALL_VIT, "depth": 2, "dropout": 0.1}),
                     attention_impl=attention, fused_ffn=True, encoder_remat=mode)
        agent = RNDAgent(cfg, 5, device=cuda)
        agent.init_state(0)
        loss, g, _ = cs.network_grads(torch, agent, host, (), rng_seed=3)
        grads[mode] = {k: v for k, v in g.items() if k.startswith("policy.")}
        mod = fq if attention == "pallas_qkv" else flash_dropout
        key = "flash_qkv_fwd" if attention == "pallas_qkv" else "flash_dropout_fwd"
        before = mod.launches[key]
        x = torch.from_numpy(host["states"].numpy()).to(cuda).float() / 255.0
        agent.network(x, Rng(3, cuda)).policy.sum().backward()
        fwd[mode] = mod.launches[key] - before
    for mode in ("full", "dots"):
        for k, v in grads[mode].items():
            assert cs.same_bits(torch, v, grads["none"][k]), (mode, k)
        assert fwd[mode] == 2 * fwd["none"] == 4, (mode, fwd)


def test_ssl_views_and_ema_on_the_card(cuda):
    """The augmentation on the card within 1e-5 of the CPU on one set of
    parameters; one BYOL minibatch step on the card moves the target by the
    EMA with equal bits and leaves it without gradients."""
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, RepresentationMethod, SSLConfig, ViTConfig
    from eavit_tpu_torch.ops.augment import AugmentParams, augment
    from eavit_tpu_torch.rl.agent import RNDAgent, TrainBatch
    from eavit_tpu_torch.models.layers import Rng

    cfg = Config(vit=ViTConfig(**SMALL_VIT), attention_impl="pallas_qkv", fused_ffn=True,
                 representation_lr_method=RepresentationMethod.BYOL,
                 ssl=SSLConfig(byol_projection_hidden_size=64, byol_projection_size=32))
    agent = RNDAgent(cfg, 5, device=cuda)
    agent.init_state(0)
    host = cs.host_batch(torch, 16)
    params = agent.ssl.draw(torch.Generator().manual_seed(1), 16, 84, 84, "cpu")[0]
    imgs = host["states"].float() / 255.0
    on_card = augment(imgs.to(cuda), AugmentParams(*(t.to(cuda) for t in params)))
    assert _max_err(on_card.cpu(), augment(imgs, params)) <= 1e-5
    batch = TrainBatch(**{k: v.to(cuda) for k, v in host.items()})
    t0 = next(agent.ssl_target.parameters()).detach().clone()
    agent._minibatch_step(batch, torch.arange(16, device=cuda), Rng(0, cuda),
                          agent.trainable_parameters())
    online = next(agent.network.feature.parameters()).detach()
    decay = cfg.ssl.byol_moving_average_decay
    assert cs.same_bits(torch, next(agent.ssl_target.parameters()).detach(),
                        t0 * decay + online * (1.0 - decay))
    assert all(p.grad is None for p in agent.ssl_target.parameters())


SMALL_HG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=384, patch_size=12)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_hg_network_on_the_card_matches_its_cpu_copy(cuda, compute_dtype):
    """The HF-flavour ``DualTokenViTHG`` (2 heads of 64, 51 tokens shared,
    qkv bias, LayerNorm eps 1e-12) through K1 and K2 on the card, against the
    same network on the CPU (plain versions): features, values and logits
    within 1e-4 in float32 and 2e-2 of their scale in bf16, the gradient of
    every parameter within 1e-3 / 5e-2 of the whole gradient's norm; one K1f,
    K2f, K1b and K2b launch a layer, K1 on its whole-head kernels at Dh 64."""
    import copy

    from eavit_tpu_torch.config import Config, ViTHGConfig, ViTImplementation
    from eavit_tpu_torch.models.layers import init_module
    from eavit_tpu_torch.models.policy import ActorCritic

    cfg = Config(vit_implementation_type=ViTImplementation.HG, vit_hg=ViTHGConfig(**SMALL_HG),
                 attention_impl="pallas_qkv", fused_ffn=True, shared_patch_stream=True,
                 compute_dtype=compute_dtype)
    cpu_net = ActorCritic(cfg, 5)
    init_module(cpu_net, torch.Generator().manual_seed(0))
    gpu_net = copy.deepcopy(cpu_net).to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).random((3, 4, 84, 84)).astype(np.float32))
    dt = getattr(torch, compute_dtype)
    keys = ((fq, fq.fwd_kernel(51, 64, dt)), (fq, fq.bwd_kernel(51, 64, dt)),
            (ff, "fused_ffn_fwd"), (ff, "fused_ffn_bwd"))
    before = [m.launches[k] for m, k in keys]
    outs = []
    for net, dev in ((gpu_net, cuda), (cpu_net, "cpu")):
        out = net(x.to(dev))
        (out.policy.sum() + out.value_ext.sum() + out.value_int.sum()).backward()
        outs.append((out, torch.cat([p.grad.float().reshape(-1).cpu()
                                     for p in net.parameters()])))
    assert [m.launches[k] - n for (m, k), n in zip(keys, before)] == [2, 2, 2, 2]
    if compute_dtype == "bfloat16":
        assert keys[0][1] == "flash_qkv_fwd" and keys[1][1] == "flash_qkv_bwd"
    (og, gg), (oc, gc) = outs
    tol = 1e-4 if compute_dtype == "float32" else 2e-2
    for name in ("features", "policy", "value_ext", "value_int"):
        ref = getattr(oc, name).detach()
        assert _max_err(getattr(og, name).detach().cpu(), ref) <= tol * max(
            1.0, ref.abs().max().item()), name
    rel = ((gg - gc).norm() / gc.norm()).item()
    assert rel <= (1e-3 if compute_dtype == "float32" else 5e-2), rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_split_path_at_the_hg_widths(cuda, dtype):
    """K2f and K2b at HG's (1,024, 3,072), eps 1e-12, rate 0.1, on a few
    rows: the split path of ffn_wide.cuh against the plain versions at the
    file's tolerances, equal bits twice."""
    d, hid, r, seeds = 1024, 3072, 170, (5, 6)
    g = torch.Generator().manual_seed(3)
    params = tuple(p.to(cuda) for p in (
        1.0 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g),
        torch.randn(hid, d, generator=g) / d ** 0.5, 0.1 * torch.randn(hid, generator=g),
        torch.randn(d, hid, generator=g) / hid ** 0.5, 0.1 * torch.randn(d, generator=g)))
    x = torch.randn(r, d, generator=g).to(cuda, dtype)
    dy = torch.randn(r, d, generator=g).to(cuda, dtype)
    assert not ff.fused_widths(d, hid, True) and not ff.fused_widths(d, hid, False)
    y = ff.fused_ffn_fwd(x, *params, seeds, 0.1, 1e-12)
    ref = ff.fused_ffn_fwd_plain(x, *params, seeds, 0.1, 1e-12)
    scale = ref.float().abs().max().item()
    assert _max_err(y, ref) <= (1e-4 * scale if dtype == torch.float32 else _bf16_tol(ref))
    assert torch.equal(y, ff.fused_ffn_fwd(x, *params, seeds, 0.1, 1e-12))
    grads = ff.fused_ffn_bwd(x, *params[:5], dy, seeds, 0.1, 1e-12)
    plain = ff.fused_ffn_bwd_plain(x, *params[:5], dy, seeds, 0.1, 1e-12)
    for i, (a, b) in enumerate(zip(grads, plain)):
        tol = 1e-4 if dtype == torch.float32 else (1.2e-2 if i == 0 else 2e-3)
        assert _max_err(a, b) <= tol * b.float().abs().max().item(), i
    again = ff.fused_ffn_bwd(x, *params[:5], dy, seeds, 0.1, 1e-12)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _serial_rollouts_equal(cfg, agent, make_env, dev):
    """Two collects by ``RolloutCollector`` and by ``DeviceRolloutCollector``
    from one Rng seed: the rollouts and final states equal bit for bit."""
    import chip_smoke as cs
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
    from eavit_tpu_torch.rl.rollout import RolloutCollector

    rollouts = []
    for cls in (RolloutCollector, DeviceRolloutCollector):
        env = make_env()
        col, rng = cls(cfg, agent, env), Rng(11, dev)
        first, states = col.collect(env.reset(), rng)
        second, states = col.collect(states, rng)
        rollouts.append((first, second, states))
    for ref, ours in zip(rollouts[0][:2], rollouts[1][:2]):
        for name in ref._fields:
            assert cs.same_bits(torch, getattr(ref, name), getattr(ours, name)), name
    np.testing.assert_array_equal(rollouts[0][2], rollouts[1][2])
    return rollouts[1][0]


def test_device_collector_continuous_on_the_card(cuda):
    """The serial ``DeviceRolloutCollector`` with continuous actions under
    PPO and NoisyNet (``pendulum_continuous.conf``'s kind) on
    ``chip_smoke.ContinuousSmokeEnv``: float ``[T, N, 1]`` actions and log-probs
    equal to ``RolloutCollector``'s bit for bit."""
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, TrainMethod, ViTConfig
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.rl.agent import RNDAgent

    cfg = Config(vit=ViTConfig(**{**SMALL_VIT, "dropout": 0.1}), num_env_per_process=4,
                 num_step=8, attention_impl="pallas_qkv", fused_ffn=True,
                 train_method=TrainMethod.PPO, use_noisy_net=True)
    agent = RNDAgent(cfg, 1, ActionSpaceType.CONTINUOUS, device=cuda)
    agent.init_state(0)
    ro = _serial_rollouts_equal(cfg, agent, lambda: cs.ContinuousSmokeEnv(4, seed=5, max_steps=4),
                                cuda)
    assert ro.actions.dtype == torch.float32
    assert tuple(ro.actions.shape) == tuple(ro.policy.shape) == (8, 4, 1)


def test_device_collector_on_the_card(cuda):
    """``DeviceRolloutCollector``: its serial rollout equals
    ``RolloutCollector``'s bit for bit on one Rng seed (dropout live, resets
    inside the rollout, two collects); the pipelined one keeps each half's
    stacks in lockstep with the env and acts twice a step."""
    import chip_smoke as cs
    from eavit_tpu_torch.config import Config, ViTConfig
    from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector

    cfg = Config(vit=ViTConfig(**{**SMALL_VIT, "dropout": 0.1}), num_env_per_process=4,
                 num_step=8, attention_impl="pallas_qkv", fused_ffn=True)
    agent = RNDAgent(cfg, 5, device=cuda)
    agent.init_state(0)
    _serial_rollouts_equal(cfg, agent,
                           lambda: SyntheticVectorEnv(4, seed=5, max_episode_steps=4), cuda)

    env = cs.HalfRecorder(SyntheticVectorEnv(4, seed=7, max_episode_steps=4))
    col = DeviceRolloutCollector(cfg.replace(async_env_pool=True), agent, env)
    assert col.pipelined
    before = fq.launches["flash_qkv_fwd"]
    ro, _ = col.collect(env.reset(), Rng(1, cuda))
    assert fq.launches["flash_qkv_fwd"] - before == 2 * (8 + 1)
    states, nxt = ro.states.cpu().numpy(), ro.next_obs.cpu().numpy()
    for lo in (0, 2):
        for t in range(8):
            np.testing.assert_array_equal(states[t, lo:lo + 2], env.rec[lo][t])
            np.testing.assert_array_equal(nxt[t, lo:lo + 2, 0], env.rec[lo][t + 1][:, -1])
