"""Flash attention: hand-written CUDA kernels and their plain versions.

Replaces the Pallas TPU kernels of ``lap_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (launched from ``_flash_forward``) by
``lap_tpu_torch/csrc/flash_attention_fwd.cu`` and ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (launched from ``_flash_backward``) by
``lap_tpu_torch/csrc/flash_attention_bwd.cu``; see the headers of the sources
for the designs. The public ``flash_attention`` is a
``torch.autograd.Function``, as the JAX one is a ``custom_vjp``.

Semantics held from the Pallas kernels: logits in float32, scaled, masked to
-2.3819763e38; online softmax in float32; GQA through kv head ``n // (N/K)``
without repeating K/V; a fully masked query row gives zeros and
``lse = -2.3819763e38`` (the kernel's mask constant) forward and a zero dQ
backward; the backward recomputes ``P = exp(S - lse)`` from the saved lse and
takes ``delta = sum_h dO * O`` in float32 before the gradient kernels (on the
card by a small kernel of its own). The CUDA kernels round P (and dS) to bf16
for their tensor-core products, where the Pallas kernels keep them in float32;
the plain versions keep them in float32 like the Pallas kernels.

The wrappers take the plain versions only for CPU tensors. On a CUDA tensor
they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

MASK_VALUE = -2.3819763e38
SUPPORTED_HEAD_DIMS = (128, 256)
SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"

# Launches of each CUDA kernel since the last reset (``launches = 0``).
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_bwd_delta = 0
launches_bwd_group_sum = 0

_I64 = ctypes.c_longlong
_SHAPE_STRIDES_SCALE_STREAM = [ctypes.c_int] * 6 + [_I64] * 11 + [ctypes.c_float, ctypes.c_void_p]
_SIGNATURE = {
    "flash_attention_fwd": [ctypes.c_void_p] * 6 + _SHAPE_STRIDES_SCALE_STREAM,
    "flash_attention_fwd_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
_BWD_SIGNATURE = {
    "flash_attention_bwd_dq": [ctypes.c_void_p] * 8 + _SHAPE_STRIDES_SCALE_STREAM,
    "flash_attention_bwd_dkv": [ctypes.c_void_p] * 10 + _SHAPE_STRIDES_SCALE_STREAM,
    "flash_attention_bwd_group_sum": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "flash_attention_bwd_delta": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [_I64] * 3 + [ctypes.c_void_p],
    "flash_attention_bwd_info": [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}

# Launch geometry of the backward kernels; mirrors the constants of
# ``csrc/flash_attention_bwd.cu`` (``backward_info`` reads the compiled
# kernels' own figures on the card).
DQ_BLOCK_M, DQ_BLOCK_N, DQ_STAGES = 64, 16, 3
DKV_BLOCK_N, DKV_BLOCK_M, DKV_STAGES = 32, 32, 2
# Launch geometry of the forward kernel; mirrors the constants of
# ``csrc/flash_attention_fwd.cu`` (``forward_info`` reads the compiled
# kernel's own figures on the card): 8 consumer warps (two warpgroups of 64
# query rows) and a producer warpgroup, 128 query rows and 64-key tiles.
FWD_BLOCK_M, FWD_BLOCK_N, FWD_STAGES, FWD_WARPS = 128, 64, 2, 8
FWD_THREADS = FWD_WARPS * 32 + 128
# Shared memory besides Q and the stages: votes, classes and barriers, and
# room to align the tiles to 1024 bytes (the 128-byte swizzle's period).
FWD_SMEM_EXTRA = 64 + 1024
FWD_MASK_LD = FWD_BLOCK_N + 16  # bytes of a staged mask row: its 16-byte aligned window
# Hopper: SMs, shared memory of an SM (the runtime reserves 1 KB of it for
# each resident block), and the most one block may take.
H100_SMS = 132
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_SHARED = 1024
BLOCK_SHARED_MAX = 227 * 1024


def flash_attention_plain(q, k, v, mask, *, scale: float | None = None):
    """Plain PyTorch version. q: [B,T,N,H]; k,v: [B,S,K,H]; mask [B,T,S].

    Returns (out [B,T,N,H] in q's dtype, lse [B,N,T] float32).
    """
    b, t, n, h = q.shape
    kh = k.shape[2]
    if scale is None:
        scale = h**-0.5
    g = n // kh
    qf = q.float().reshape(b, t, kh, g, h)
    s = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) * scale
    m = mask[:, None, None, :, :]
    s = torch.where(m, s, MASK_VALUE)
    row_max = s.amax(dim=-1, keepdim=True)
    dead = row_max <= MASK_VALUE / 2
    safe_max = torch.where(dead, 0.0, row_max)
    p = torch.where(m, torch.exp(s - safe_max), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.float()) / denom.permute(0, 3, 1, 2, 4)
    lse = torch.where(dead, MASK_VALUE, row_max + torch.log(denom))[..., 0]
    return out.reshape(b, t, n, h).to(q.dtype), lse.reshape(b, n, t)


def forward_plan(b, t, s, n, kh, h, sms: int = H100_SMS):
    """Launch geometry of the forward kernel for q [b, t, n, h] and k, v
    [b, s, kh, h], from the shapes alone: a block owns 128 query rows of one
    (head, batch) and walks every 64-key tile, one block an SM. Raises on
    shapes the kernel cannot take."""
    if h not in SUPPORTED_HEAD_DIMS or min(b, t, s, n, kh) < 1 or n % kh:
        raise ValueError(f"the forward kernel cannot take B={b} T={t} S={s} N={n} K={kh} H={h}")
    row_tiles = -(-t // FWD_BLOCK_M)
    smem = FWD_BLOCK_M * h * 2 + FWD_STAGES * (2 * FWD_BLOCK_N * h * 2 + FWD_BLOCK_M * FWD_MASK_LD) + FWD_SMEM_EXTRA
    blocks_per_sm = SM_SHARED_BYTES // (smem + BLOCK_RESERVED_SHARED)
    blocks = row_tiles * n * b
    return dict(
        grid=(row_tiles, n, b), blocks=blocks, key_tiles=-(-s // FWD_BLOCK_N), smem=smem,
        blocks_per_sm=blocks_per_sm, waves=blocks / (sms * blocks_per_sm), threads=FWD_THREADS,
    )


def forward_info(h):
    """Registers and local (spill) bytes a thread, dynamic shared memory and
    resident blocks per SM (occupancy query) of the compiled forward kernel
    at head dim ``h`` on the current card."""
    from lap_tpu_torch import cuda_build

    out = (ctypes.c_int * 4)()
    err = cuda_build.load(SOURCE, _SIGNATURE).flash_attention_fwd_info(h, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_info failed with cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1], smem=out[2], blocks_per_sm=out[3])


def flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale: float | None = None):
    """Plain PyTorch backward, the formulas of the Pallas kernels in float32.

    P is recomputed from the saved ``lse`` (not by a second softmax), zero
    where masked and on rows whose ``lse`` says "no keys". Returns
    (dq, dk, dv) in the dtypes of q, k and v.
    """
    b, t, n, h = q.shape
    kh = k.shape[2]
    if scale is None:
        scale = h**-0.5
    g = n // kh
    qf = q.float().reshape(b, t, kh, g, h)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, t, kh, g, h)
    delta = (dof * out.float().reshape(b, t, kh, g, h)).sum(dim=-1)  # [B,T,K,G]
    delta = delta.permute(0, 2, 3, 1)[..., None]  # [B,K,G,T,1]
    lse = lse.reshape(b, kh, g, t)[..., None]
    live = mask[:, None, None, :, :] & (lse > MASK_VALUE / 2)
    s = torch.einsum("btkgh,bskh->bkgts", qf, kf) * scale
    p = torch.where(live, torch.exp(s - torch.where(lse > MASK_VALUE / 2, lse, 0.0)), 0.0)
    dv = torch.einsum("bkgts,btkgh->bskh", p, dof)
    dp = torch.einsum("btkgh,bskh->bkgts", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgts,bskh->btkgh", ds, kf) * scale
    dk = torch.einsum("bkgts,btkgh->bskh", ds, qf) * scale
    return dq.reshape(b, t, n, h).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_delta_plain(out, dout):
    """delta [B, N, T] = sum_h dO * O in float32 from out, dout [B, T, N, H]."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def backward_plan(b, t, s, n, kh, h):
    """Launch geometry of the backward kernels for q [b, t, n, h] and k, v
    [b, s, kh, h]: grids, dynamic shared memory per block, the blocks per SM
    that shared memory allows, the f32 scratch of the GQA group sum (None when
    the group is 1) and whether the group-sum pass runs."""
    group = n // kh

    def blocks_per_sm(smem):
        return SM_SHARED_BYTES // (smem + BLOCK_RESERVED_SHARED)

    dq_smem = (2 * DQ_BLOCK_M + 2 * DQ_STAGES * DQ_BLOCK_N) * h * 2
    dkv_smem = ((2 * DKV_BLOCK_N + 2 * DKV_STAGES * DKV_BLOCK_M) * h * 2
                + 2 * DKV_BLOCK_N * DKV_BLOCK_M * 2 + DKV_BLOCK_N * DKV_BLOCK_M * 4
                + 2 * DKV_STAGES * DKV_BLOCK_M * 4)
    return dict(
        group=group,
        dq_grid=(-(-t // DQ_BLOCK_M), n, b), dq_smem=dq_smem, dq_blocks_per_sm=blocks_per_sm(dq_smem),
        dkv_grid=(-(-s // DKV_BLOCK_N), n, b), dkv_smem=dkv_smem, dkv_blocks_per_sm=blocks_per_sm(dkv_smem),
        scratch_shape=(2, b, s, n, h) if group > 1 else None,
        group_sum=group > 1,
    )


def backward_info(h):
    """{"dq": ..., "dkv": ...} of the compiled kernels at head dim ``h`` on
    the current card: registers and local (spill) bytes a thread, dynamic
    shared memory, and resident blocks per SM from the occupancy query."""
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(BWD_SOURCE, _BWD_SIGNATURE)
    info = {}
    for which, name in enumerate(("dq", "dkv")):
        out = (ctypes.c_int * 4)()
        err = lib.flash_attention_bwd_info(which, h, out)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_info failed with cudaError {err}")
        info[name] = dict(registers=out[0], local_bytes=out[1], smem=out[2], blocks_per_sm=out[3])
    return info


def _check_operand(name, x, rank=4):
    if x.dim() != rank:
        raise ValueError(f"{name} must have rank {rank}, got shape {tuple(x.shape)}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a unit stride on the head dim, other strides that are "
            f"multiples of 8 and 16-byte alignment; got strides {x.stride()}"
        )


def _check_call(q, k, v, mask):
    b, t, n, h = q.shape
    _, s, kh, _ = k.shape
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head dims {SUPPORTED_HEAD_DIMS}, got {h}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError("flash kernel takes bfloat16 q, k and v")
    if n % kh or k.shape != v.shape or k.shape[0] != b or tuple(mask.shape) != (b, t, s):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} mask {tuple(mask.shape)}")
    if not (k.device == v.device == mask.device == q.device):
        raise ValueError("q, k, v and mask must be on one device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x)
    if mask.dtype != torch.bool or mask.stride(-1) != 1:
        raise ValueError("mask must be bool with a unit stride on its last axis")
    if t == 0 or s == 0:
        raise ValueError("flash kernel needs at least one query and one key")


def _shape_strides_scale_stream(q, k, v, mask, scale):
    b, t, n, h = q.shape
    return (
        b, t, k.shape[1], n, k.shape[2], h,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        mask.stride(0), mask.stride(1),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )


def _launch(q, k, v, mask, scale):
    global launches
    _check_call(q, k, v, mask)
    b, t, n, h = q.shape
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(SOURCE, _SIGNATURE)
    out = torch.empty((b, t, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        *_shape_strides_scale_stream(q, k, v, mask, scale),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with cudaError {err}")
    launches += 1
    return out, lse


def flash_attention_forward(q, k, v, mask, *, scale: float | None = None):
    """Flash attention returning (out [B,T,N,H], lse [B,N,T] float32).

    q: [B,T,N,H]; k, v: [B,S,K,H] with N a multiple of K; mask: [B,T,S] bool,
    True = may attend; scale defaults to H**-0.5.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _launch(q, k, v, mask, scale)
    return flash_attention_plain(q, k, v, mask, scale=scale)


def _launch_delta(out, dout):
    """delta [B, N, T] from the contiguous bf16 ``dout`` by the delta kernel."""
    global launches_bwd_delta
    _check_operand("out", out)
    if out.dtype != torch.bfloat16 or out.shape != dout.shape or out.device != dout.device:
        raise ValueError("out must be a bfloat16 tensor shaped like the output gradient, on its device")
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(BWD_SOURCE, _BWD_SIGNATURE)
    b, t, n, h = out.shape
    delta = torch.empty((b, n, t), dtype=torch.float32, device=out.device)
    err = lib.flash_attention_bwd_delta(
        dout.data_ptr(), out.data_ptr(), delta.data_ptr(), b, t, n, h, *out.stride()[:3],
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_delta launch failed with cudaError {err}")
    launches_bwd_delta += 1
    return delta


def flash_attention_delta(out, dout):
    """delta [B, N, T] = sum_h dO * O in float32: the kernel on CUDA tensors,
    the plain version on the CPU."""
    if out.is_cuda:
        return _launch_delta(out, dout.contiguous())
    return flash_attention_delta_plain(out, dout)


def flash_attention_group_sum_plain(partial, kh):
    """The GQA group sum of per-head f32 partials [2, B, S, N, H]: heads
    ``kh * G .. kh * G + G - 1`` added in that order in float32, then
    (dk, dv) [B, S, kh, H] in bfloat16."""
    _, b, s, n, h = partial.shape
    heads = partial.reshape(2, b, s, kh, n // kh, h).unbind(dim=4)
    acc = heads[0]
    for head in heads[1:]:
        acc = acc + head
    dk, dv = acc.to(torch.bfloat16).unbind(0)
    return dk, dv


def flash_attention_group_sum(partial, kh):
    """``flash_attention_group_sum_plain`` by the group-sum kernel on CUDA
    tensors (the same additions in the same order: the same bits)."""
    global launches_bwd_group_sum
    if not partial.is_cuda:
        return flash_attention_group_sum_plain(partial, kh)
    _, b, s, n, h = partial.shape
    if partial.dtype != torch.float32 or not partial.is_contiguous() or n % kh or h % 4:
        raise ValueError(f"partial must be contiguous float32 [2, B, S, N, H] with N a multiple of {kh}")
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(BWD_SOURCE, _BWD_SIGNATURE)
    dk = torch.empty((b, s, kh, h), dtype=torch.bfloat16, device=partial.device)
    dv = torch.empty_like(dk)
    err = lib.flash_attention_bwd_group_sum(
        partial.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, kh, n // kh, h,
        torch.cuda.current_stream(partial.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_group_sum launch failed with cudaError {err}")
    launches_bwd_group_sum += 1
    return dk, dv


def flash_attention_backward_kernels(q, k, v, mask, lse, dout, delta, *, scale: float | None = None,
                                     need_dq: bool = True, need_dkv: bool = True):
    """The gradient kernels alone on CUDA tensors, from a contiguous bf16
    ``dout`` and its ``delta`` [B, N, T]: dQ, and dK/dV followed by the group
    sum when N > K. Returns (dq, dk, dv), None where not needed."""
    global launches_bwd_dq, launches_bwd_dkv
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_call(q, k, v, mask)
    if dout.device != q.device or dout.dtype != torch.bfloat16 or dout.shape != q.shape:
        raise ValueError("the output gradient must be a bfloat16 tensor shaped like q, on q's device")
    if not dout.is_contiguous():
        raise ValueError("the gradient kernels read a contiguous output gradient")
    b, t, n, h = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, n, t) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [B, N, T]")
    from lap_tpu_torch import cuda_build

    lib = cuda_build.load(BWD_SOURCE, _BWD_SIGNATURE)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = _shape_strides_scale_stream(q, k, v, mask, scale)
    main = torch.cuda.current_stream(q.device)
    # With both, dQ runs on a second stream beside dK/dV, so that each kernel's
    # last, partly filled wave of blocks shares the card with the other's.
    # The outputs and the inputs' memory belong to the current stream, which
    # waits for the second one before returning.
    side = _side_stream(q.device) if need_dq and need_dkv else main
    dq = dk = dv = None
    if need_dq:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        side.wait_stream(main)
        err = lib.flash_attention_bwd_dq(*common, dq.data_ptr(), *tail[:-1], side.cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_dq launch failed with cudaError {err}")
        launches_bwd_dq += 1
    if need_dkv:
        s, kh = k.shape[1], k.shape[2]
        plan = backward_plan(b, t, s, n, kh, h)
        partial = None
        if plan["group_sum"]:
            partial = torch.empty(plan["scratch_shape"], dtype=torch.float32, device=q.device)
        else:
            dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
            dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        err = lib.flash_attention_bwd_dkv(
            *common, None if dk is None else dk.data_ptr(), None if dv is None else dv.data_ptr(),
            None if partial is None else partial.data_ptr(), *tail,
        )
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_dkv launch failed with cudaError {err}")
        launches_bwd_dkv += 1
        if partial is not None:
            dk, dv = flash_attention_group_sum(partial, kh)
    if side is not main:
        main.wait_stream(side)
    return dq, dk, dv


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _launch_backward(q, k, v, mask, out, lse, dout, scale, *, need_dq=True, need_dkv=True):
    """delta, then the gradient kernels; returns (dq, dk, dv), None where not needed."""
    _check_call(q, k, v, mask)
    if dout.device != q.device or dout.dtype != torch.bfloat16 or dout.shape != q.shape:
        raise ValueError("the output gradient must be a bfloat16 tensor shaped like q, on q's device")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("lse must be float32 [B, N, T]")
    # Gradients arrive from autograd in any layout; the kernels read [B,T,N,H].
    dout = dout.contiguous()
    delta = _launch_delta(out, dout)
    return flash_attention_backward_kernels(q, k, v, mask, lse.contiguous(), dout, delta, scale=scale,
                                            need_dq=need_dq, need_dkv=need_dkv)


def flash_attention_backward(q, k, v, mask, out, lse, dout, *, scale: float | None = None,
                             need_dq: bool = True, need_dkv: bool = True):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``dout``,
    from the forward's ``out`` and ``lse``. On CUDA tensors only the kernels
    that are needed are launched (dq; dk and dv together), the rest is None."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _launch_backward(q, k, v, mask, out, lse, dout, scale, need_dq=need_dq, need_dkv=need_dkv)
    return flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, lse = flash_attention_forward(q, k, v, mask, scale=scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_backward(
            *ctx.saved_tensors, dout, scale=ctx.scale, need_dq=need_q, need_dkv=need_k or need_v
        )
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask, *, scale: float | None = None) -> torch.Tensor:
    """Flash attention output only ([B,T,N,H] in q's dtype), differentiable
    in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, mask, float(scale))
