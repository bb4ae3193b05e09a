#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Two paths are driven: LAP-3B flow-matching serving (phases 5-8) and the LAP-3B
training step (phases 9-10). Phases, in order; any failure exits non-zero:
 1. build every CUDA kernel of the paths from the sources in this checkout
    (``lap_tpu_torch/csrc/``, into ``lap_tpu_torch/_build/``), one ``nvcc``
    per source, in parallel;
 2. hold each kernel (the flash forward, the dQ and the dK/dV backward)
    against its plain PyTorch version on the card, on the paths' shapes and
    edge cases, with the tolerances stated below; the training call is held
    at the path's batch and with the strides the model gives it (q and the
    mask are the first 692 rows of the joint 708-row tensors), forward (out,
    lse) and backward;
 3. time each kernel, its plain version and one PyTorch library call that
    computes the same function (a yardstick the port never calls), beside the
    least time the card could take (``bound_ms``); the backward kernels are
    timed last, at the batch the training path ran with;
 4. run the dummy-size model in f32 on the card and on the CPU with the same
    weights (the CPU path is what the tests hold against the JAX package):
    ``sample_actions``, and one training pass (loss, every gradient leaf and
    the global gradient norm);
 5. build the full-width LAP-3B flow policy (gemma_2b + gemma_300m + SigLIP
    So400m/14, bf16) on the card from seeded random weights;
 6. serve requests through ``Policy.infer`` with the launch counters reset
    just before and read just after: 18 flash launches per request;
 7. compare ``sample_actions`` with ``attn_impl="flash"`` against
    ``attn_impl="xla"`` on one request with the same noise;
 8. report infer latency (p50, p90 over ``N_REQUESTS`` closed-loop requests
    at batch 1) and the chunk rate, and profile one more request: device
    time by kernel against its wall time;
 9. build the full-width LAP-3B trainer (the ``lap`` config: float32
    parameters under bf16 activations, AdamW, EMA, stop-gradient, per-layer
    rematerialisation) from seeded random weights and take optimizer steps on
    the synthetic batch with the launch counters reset just before and read
    just after: per step 36 forward (18 layers, run again by the
    rematerialisation), 18 dQ and 18 dK/dV launches; the loss is finite and
    falls; step time, peak memory, and one profiled step with its device
    time summed by kernel family over every kernel;
10. compare one loss-and-gradient pass with the kernels against one with
    ``attn_impl="xla"`` from the same weights, batch, noise and time, and the
    float32 global gradient norm against a float64 sum over the same
    gradients.

The last lines of standard output are the ``kernels`` JSON line, the card's
name and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.
The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version, bf16 inputs. The kernel rounds P to bf16 before
# the P.V product (the plain version keeps P in f32) and both round the
# output to bf16: allow 2 bf16 ulps relative plus an absolute floor.
OUT_ATOL, OUT_RTOL = 4e-3, 1.6e-2
# lse: the same f32 logits summed in another order.
LSE_ATOL = 1e-3
# Backward kernels vs the plain backward (f32 P and dS) on the same bf16
# inputs and the kernel's own out and lse. The kernels round P and dS to bf16
# before the second products and the gradients to bf16: allow 2 bf16 ulps
# relative plus 2 ulps of the gradient's largest entry (sums of rounded terms).
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1.6e-2, 1.6e-2
# Whole path, flash vs einsum attention: the einsum path rounds P to bf16
# and the prefix K/V cache differs in the last bf16 bit; the difference
# passes through 18 random-weight layers and 10 Euler steps (measured
# 1.4e-3 on an H100; 7x margin).
PATH_REL_TOL = 1e-2
# The dummy-size model in f32 on the card against the same weights on the
# CPU: f32 sums in another order (TF32 off).
SMALL_REF_TOL = 1e-4

# The dummy-size training step in f32, card vs CPU: the loss, and every
# gradient leaf within SMALL_TRAIN_TOL of its largest entry plus 1e-6.
SMALL_TRAIN_TOL = 2e-4
# One full-width loss-and-gradient pass, flash kernels vs einsum attention:
# bf16 activations through 18 rematerialised layers; the kernels round P and
# dS to bf16 where the einsum path rounds P only.
TRAIN_LOSS_REL_TOL = 5e-3
TRAIN_GRAD_NORM_REL_TOL = 5e-2
# The card's global norm (float32 per-tensor norms, one fused launch) against
# float64 accumulation over the same gradients.
NORM_REL_TOL = 1e-5

# Closed loop, one client, batch 1: p90 has three beyond it.
N_REQUESTS = 30
TRAIN_BATCH = 8  # per device; float32 parameters and EMA fit an 80 GB card at this batch
TRAIN_WARMUP_STEPS, TRAIN_STEPS = 2, 6
LAP_PREFIX = 2 * 256 + 180  # two 224^2 cameras at patch 14, plus the prompt
PROMPT_LEN, PROMPT_VALID = 180, 40
ACTION_HORIZON = 16
LANGACT_START = 8  # first language-action slot of the synthetic training prompt
TRAINING_CASE = "training_step"  # the kernel case with the training path's shape, batch and strides


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_cuda(fn, *, warmup: int = 5, iters: int = 50, reps: int = 5) -> float:
    """Median over ``reps`` of the mean ms per call over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Flash-attention kernel
# ---------------------------------------------------------------------------


def prefix_lm_mask(valid, ar_tail, size, device):
    """[B, size, size] prefix-LM mask: row b has ``valid[b]`` real tokens,
    the last ``ar_tail[b]`` of them causal."""
    import torch

    from lap_tpu_torch.ops.masks import make_attn_mask

    idx = torch.arange(size, device=device)[None, :]
    nv = torch.tensor(valid, device=device)[:, None]
    tail = torch.tensor(ar_tail, device=device)[:, None]
    input_mask = idx < nv
    mask_ar = (idx >= nv - tail) & input_mask
    return make_attn_mask(input_mask, mask_ar).contiguous()


def kernel_cases(device):
    import torch

    g = torch.Generator(device=device).manual_seed(0)

    def rand_mask(b, t, s, p, dead_rows=0):
        m = torch.rand((b, t, s), generator=g, device=device) < p
        if dead_rows:
            rows = torch.randperm(t, generator=g, device=device)[:dead_rows]
            m[:, rows, :] = False
        return m

    path_mask = prefix_lm_mask([512 + PROMPT_VALID], [0], LAP_PREFIX, device)
    return [
        # name, (B, T, S, N, K, H), mask
        ("path_prefix_lm", (1, LAP_PREFIX, LAP_PREFIX, 8, 1, 256), path_mask),
        ("b2_unequal_padding", (2, 300, 300, 8, 1, 256), prefix_lm_mask([250, 180], [30, 12], 300, device)),
        ("gqa_k2", (1, 256, 256, 8, 2, 256), rand_mask(1, 256, 256, 0.7)),
        ("gqa_k8", (1, 200, 200, 8, 8, 256), rand_mask(1, 200, 200, 0.7)),
        ("head_dim_128", (1, 384, 384, 8, 1, 128), prefix_lm_mask([300], [20], 384, device)),
        ("fully_masked_rows", (1, 257, 257, 8, 1, 256), rand_mask(1, 257, 257, 0.5, dead_rows=40)),
        ("ragged_t_s", (1, 100, 333, 4, 1, 256), rand_mask(1, 100, 333, 0.5)),
    ]


def check_forward(name, q, k, v, mask, out, lse) -> float:
    """The forward kernel's ``out`` and ``lse`` against the plain version."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    (b, t, n, h), s, kh = q.shape, k.shape[1], k.shape[2]
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    err = (out.float() - ref_out.float()).abs()
    bound = OUT_ATOL + OUT_RTOL * ref_out.float().abs()
    lse_err = (lse - ref_lse).abs().max().item()
    dead = ~mask.any(dim=-1)  # [B, T]
    log(
        f"kernel flash_attention_fwd case={name} shape=B{b} T{t} S{s} N{n} K{kh} H{h} "
        f"out_max_abs_err={err.max().item():.3e} lse_max_abs_err={lse_err:.3e} "
        f"dead_rows={int(dead.sum())} q_strides={tuple(q.stride())} mask_strides={tuple(mask.stride())}"
    )
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: out differs beyond atol {OUT_ATOL} + rtol {OUT_RTOL}")
    if lse_err > LSE_ATOL:
        raise AssertionError(f"{name}: lse differs by {lse_err} > {LSE_ATOL}")
    if dead.any() and out.float()[dead].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: fully masked rows are not zero")
    return err.max().item()


def check_flash_kernel(device):
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(1)
    worst = 0.0
    for name, (b, t, s, n, kh, h), mask in kernel_cases(device):
        q = torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16)
        k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        out, lse = fa.flash_attention_forward(q, k, v, mask)
        torch.cuda.synchronize()
        worst = max(worst, check_forward(name, q, k, v, mask, out, lse))
    return worst


def time_flash_kernel(device):
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(2)
    b, t, n, kh, h = 1, LAP_PREFIX, 8, 1, 256
    mask = prefix_lm_mask([512 + PROMPT_VALID], [0], t, device)
    q = torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16)
    k = torch.randn((b, t, kh, h), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((b, t, kh, h), generator=g, device=device).to(torch.bfloat16)
    kernel_ms = time_cuda(lambda: fa.flash_attention_forward(q, k, v, mask))
    plain_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, mask), iters=10)
    # Yardstick only: one PyTorch call computing the same attention.
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa_mask = mask[:, None]
    library_ms = time_cuda(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True)
    )
    # Least time for the same work: only the unmasked (query, key) pairs need
    # the two products (2 flops per multiply-add each); each input is read
    # once and each output written once.
    pairs = int(mask.sum())
    flops = 4 * n * h * pairs
    nbytes = (
        q.numel() * 2 + k.numel() * 2 + v.numel() * 2 + mask.numel()
        + q.numel() * 2 + b * n * t * 4
    )
    flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    log(
        f"timing flash_attention_fwd B{b} T=S={t} N{n} K{kh} H{h}: kernel_ms={kernel_ms:.5f} "
        f"plain_ms={plain_ms:.5f} library_ms(sdpa)={library_ms:.5f} bound_ms={bound_ms:.5f} "
        f"(flops={flops} -> {flops_ms:.5f} ms, bytes={nbytes} -> {bytes_ms:.5f} ms; "
        f"dense flops {4 * n * h * t * t})"
    )
    return dict(
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
    )


def training_mask(batch, device):
    """The mask of the prefix call of one LAP-3B training step, as the model
    passes it: the first 692 rows ([B, 692, 708], not contiguous) of the joint
    [B, 708, 708] mask. Image and prompt tokens bidirectional, the
    language-action tokens (prompt slot 8 on) causal, the 16 action-token
    columns all false; the action rows, cut off here, see every key."""
    import torch

    prefix = prefix_lm_mask([LAP_PREFIX], [PROMPT_LEN - LANGACT_START], LAP_PREFIX, device)
    joint = torch.nn.functional.pad(prefix, (0, ACTION_HORIZON, 0, ACTION_HORIZON))
    joint[:, LAP_PREFIX:] = True
    return joint.expand(batch, -1, -1).contiguous()[:, :LAP_PREFIX]


def training_queries(batch, generator, device):
    """Queries (or an output gradient's worth of values) laid out as the model
    lays them out for the prefix call: the first 692 rows of the joint
    [B, 708, 8, 256] tensor, so the batch stride is that of 708 rows."""
    import torch

    joint = torch.randn((batch, LAP_PREFIX + ACTION_HORIZON, 8, 256), generator=generator, device=device)
    return joint.to(torch.bfloat16)[:, :LAP_PREFIX]


def backward_cases(device):
    import torch

    g = torch.Generator(device=device).manual_seed(3)
    gqa4 = torch.rand((2, 300, 270), generator=g, device=device) < 0.6
    gqa4[:, 17:40] = False  # fully masked rows
    gqa4[:, :, 100:133] = False  # all-false key columns
    return [
        *kernel_cases(device),
        (TRAINING_CASE, (TRAIN_BATCH, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256),
         training_mask(TRAIN_BATCH, device)),
        ("gqa_group4_h128", (2, 300, 270, 8, 2, 128), gqa4),
    ]


def check_flash_backward(device):
    """dQ, dK, dV of the two backward kernels against the plain backward, on
    the forward kernel's own out and lse, which are held against the plain
    forward first (the only place the forward sees S = 708)."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(4)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, (b, t, s, n, kh, h), mask in backward_cases(device):
        if name == TRAINING_CASE:
            q = training_queries(b, g, device)
        else:
            q = torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16)
        k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        # The output gradient arrives as a slice of the joint tensor's too.
        dout = (training_queries(b, g, device) if name == TRAINING_CASE
                else torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16))
        out, lse = fa.flash_attention_forward(q, k, v, mask)
        grads = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], check_forward(name, q, k, v, mask, out, lse))
        refs = fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout)
        dead_rows = ~mask.any(dim=-1)  # [B, T]
        dead_cols = ~mask.any(dim=-2)  # [B, S]
        errs = []
        for label, got, ref in zip(("dq", "dk", "dv"), grads, refs, strict=True):
            got, ref = got.float(), ref.float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite {label}")
            err = (got - ref).abs()
            bound = GRAD_ATOL_OF_MAX * ref.abs().max() + GRAD_RTOL * ref.abs()
            if bool((err > bound).any()):
                raise AssertionError(
                    f"{name}: {label} differs by {err.max().item():.3e} "
                    f"(max |ref| {ref.abs().max().item():.3e})"
                )
            errs.append((label, err.max().item(), ref.abs().max().item()))
            key = "dq" if label == "dq" else "dkv"
            worst[key] = max(worst[key], err.max().item())
        if dead_rows.any() and grads[0].float()[dead_rows].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: dQ of fully masked rows is not zero")
        if dead_cols.any():
            for label, got in (("dk", grads[1]), ("dv", grads[2])):
                if got.float()[dead_cols].abs().max().item() != 0.0:
                    raise AssertionError(f"{name}: {label} of all-false key columns is not zero")
        log(
            f"kernel flash_attention_bwd case={name} shape=B{b} T{t} S{s} N{n} K{kh} H{h} "
            + " ".join(f"{lb}_max_abs_err={e:.3e} (max|ref| {m:.3e})" for lb, e, m in errs)
            + f" dead_rows={int(dead_rows.sum())} dead_cols={int(dead_cols.sum())}"
        )
    return worst


def time_flash_backward(device, batch):
    """Both backward kernels at the training shape, beside their bounds, the
    plain backward and autograd through ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(5)
    b, t, s, n, kh, h = batch, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256
    mask = training_mask(b, device)
    q = training_queries(b, g, device)
    k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
    dout = training_queries(b, g, device)  # the wrapper's copy to a contiguous dO is in each time
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    scale = h**-0.5

    def run(**need):
        return fa.flash_attention_backward(q, k, v, mask, out, lse, dout, scale=scale, **need)

    # Each time includes the wrapper's delta = sum(dO * O), as the path pays it.
    dq_ms = time_cuda(lambda: run(need_dq=True, need_dkv=False), iters=20)
    dkv_ms = time_cuda(lambda: run(need_dq=False, need_dkv=True), iters=20)
    delta_ms = time_cuda(
        lambda: (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous(), iters=20
    )
    fwd_ms = time_cuda(lambda: fa.flash_attention_forward(q, k, v, mask), iters=20)
    plain_ms = time_cuda(
        lambda: fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale),
        iters=3, reps=3, warmup=1,
    )
    # Yardstick only: autograd through one PyTorch call, dq, dk and dv together.
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).detach().requires_grad_()
    vt = v.transpose(1, 2).detach().requires_grad_()
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    library_ms = time_cuda(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), iters=20
    )

    pairs = int(mask.sum())
    row_bytes = 2 * b * n * t * 4  # lse and delta
    in_bytes = 2 * q.numel() * 2 + k.numel() * 2 + v.numel() * 2 + mask.numel() + row_bytes
    results = {}
    for name, ms, products, out_bytes in (
        ("dq", dq_ms, 3, q.numel() * 2),
        ("dkv", dkv_ms, 4, 2 * k.numel() * 2),
    ):
        flops = 2 * products * n * h * pairs
        flops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
        results[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(flops_ms, bytes_ms),
            bound_by="operations" if flops_ms >= bytes_ms else "bytes",
            # The plain backward and the library call each give dq, dk and dv at once.
            plain_and_library_cover="dq+dkv", batch=b,
        )
        log(
            f"timing flash_attention_bwd_{name} B{b} T{t} S{s} N{n} K{kh} H{h}: kernel_ms={ms:.5f} "
            f"(of which delta {delta_ms:.5f}) bound_ms={results[name]['bound_ms']:.5f} "
            f"(flops={flops} -> {flops_ms:.5f} ms, bytes={in_bytes + out_bytes} -> {bytes_ms:.5f} ms)"
        )
    log(
        f"timing flash_attention_bwd B{b}: dq+dkv kernel_ms={dq_ms + dkv_ms:.5f} "
        f"plain_ms(dq, dk, dv together)={plain_ms:.5f} "
        f"library_ms(sdpa backward, dq, dk, dv together)={library_ms:.5f} "
        f"forward kernel at this shape ms={fwd_ms:.5f}"
    )
    return results


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


def make_request(seed: int, config):
    """One model-ready request: uint8 cameras, state, a 180-slot prompt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = config.image_resolution
    tokens = np.zeros(PROMPT_LEN, np.int32)
    tokens[:PROMPT_VALID] = rng.integers(2, 257_152, PROMPT_VALID)
    return {
        "image": {k: rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for k in config.image_keys},
        "image_mask": {k: np.bool_(True) for k in config.image_keys},
        "state": rng.standard_normal(config.action_dim).astype(np.float32),
        "tokenized_prompt": tokens,
        "tokenized_prompt_mask": np.arange(PROMPT_LEN) < PROMPT_VALID,
    }


# Kernel families of a profile, by substrings of the kernel's name; the first
# family that matches takes the kernel, "other" the rest.
KERNEL_FAMILIES = (
    ("flash kernels", ("flash_",)),
    ("foreach passes (optimizer, EMA, norms)", ("multi_tensor_apply",)),
    ("convolution", ("cudnn", "convolve", "fprop", "wgrad", "dgrad")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("copies and casts", ("Memcpy", "Memset", "copy", "CatArray")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def report_profile(prof, what: str, wall_ms: float) -> None:
    """Device time of one profiled call against its wall time: the largest
    kernels by name, then every kernel summed by family, so that the families
    add up to the whole device time."""
    events = [e for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    log(f"profile: one {what} wall_ms={wall_ms:.3f} device_kernel_ms={device_ms:.3f} "
        f"kernels={sum(e.count for e in events)}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        log(f"profile:   {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    families: dict[str, list] = {name: [0.0, 0] for name, _ in KERNEL_FAMILIES}
    families["other"] = [0.0, 0]
    other = []
    for e in events:
        family = next((name for name, keys in KERNEL_FAMILIES if any(k in e.key for k in keys)), "other")
        families[family][0] += e.device_time_total / 1e3
        families[family][1] += e.count
        if family == "other":
            other.append(e)
    for name, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        log(f"profile:   family {ms:9.3f} ms ({100 * ms / device_ms:5.1f}%)  x{count:<5d} {name}")
    for e in sorted(other, key=lambda e: -e.device_time_total)[:4]:
        log(f"profile:   other  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    for e in events:
        if "flash_" in e.key:
            log(f"profile:   flash  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


def profile_one_request(policy, request) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        policy.infer(request)
        wall_ms = (time.monotonic() - t0) * 1e3
    report_profile(prof, "infer", wall_ms)


def run_policy(device):
    import numpy as np
    import torch

    from lap_tpu_torch.models.lap_model import LAP, LAPConfig
    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.policies.policy import Policy, _stack_batch

    config = LAPConfig(
        action_dim=7, action_horizon=16, max_token_len=PROMPT_LEN, enable_action_training=True
    )
    t0 = time.monotonic()
    model = LAP(config, device=device, init_seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"policy: built LAP-3B ({n_params} params, bf16) in {time.monotonic() - t0:.1f} s")
    policy = Policy(model, num_steps=10, seed=0)

    requests = [make_request(i, config) for i in range(N_REQUESTS)]
    warm = policy.infer(requests[0])  # first call: cuBLAS/cuDNN setup
    log(f"policy: warm-up infer {warm['policy_timing']['infer_ms']:.1f} ms")

    fa.launches = 0
    latencies, per_request = [], []
    for req in requests:
        before = fa.launches
        out = policy.infer(req)
        per_request.append(fa.launches - before)
        latencies.append(out["policy_timing"]["infer_ms"])
        actions = out["actions"]
        if actions.shape != (16, 7) or not np.isfinite(actions).all():
            raise AssertionError(f"bad actions: shape {actions.shape}")
    launches = fa.launches
    log(f"policy: flash launches per request {per_request} (total {launches})")
    if any(c != 18 for c in per_request):
        raise AssertionError(f"expected 18 flash launches per request, got {per_request}")

    # Flash vs einsum attention on one request, same noise.
    obs = CoTObservation.from_dict(_stack_batch([requests[0]]), device=device)
    noise = torch.randn(
        (1, config.action_horizon, config.action_dim),
        generator=torch.Generator(device=device).manual_seed(5), device=device,
    )
    with torch.inference_mode():
        a_flash = model.sample_actions(obs, noise=noise)
        model.set_attn_impl("xla")
        a_xla = model.sample_actions(obs, noise=noise)
        model.set_attn_impl(config.attn_impl)
    rel = ((a_flash - a_xla).norm() / a_xla.norm()).item()
    max_abs = (a_flash - a_xla).abs().max().item()
    log(
        f"path: flash vs xla attention actions rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
        f"|actions|_max={a_xla.abs().max().item():.3e}"
    )
    if not (torch.isfinite(a_flash).all() and torch.isfinite(a_xla).all()):
        raise AssertionError("non-finite actions")
    if rel > PATH_REL_TOL:
        raise AssertionError(f"flash vs xla actions differ: rel {rel} > {PATH_REL_TOL}")

    profile_one_request(policy, requests[0])

    lat = sorted(latencies)
    p50 = statistics.median(lat)
    p90 = lat[min(len(lat) - 1, math.ceil(0.9 * len(lat)) - 1)]
    log(
        f"policy: infer over {len(lat)} requests p50_ms={p50:.3f} p90_ms={p90:.3f} "
        f"chunk_rate_hz={1000.0 / p50:.3f} all_ms={[round(x, 3) for x in latencies]} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}"
    )
    return launches


def check_small_reference(device) -> None:
    """The dummy-size model in f32 on the card against the same weights on
    the CPU, the path the CPU tests hold against the JAX package."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.lap_model import LAP, LAPConfig
    from lap_tpu_torch.models.types import CoTObservation

    config = LAPConfig(
        dtype="float32", paligemma_variant="dummy", action_expert_variant="dummy",
        siglip_variant="dummy", action_horizon=4, max_token_len=16,
        image_resolution=(28, 28), enable_action_training=True,
    )
    cpu = LAP(config, device="cpu", init_seed=0)
    gpu = LAP(config, device=device, init_seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    batch = {
        "image": {k: rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8) for k in config.image_keys},
        "state": rng.standard_normal((2, 7)).astype(np.float32),
        "tokenized_prompt": rng.integers(0, 257_152, (2, 16)).astype(np.int32),
        "tokenized_prompt_mask": np.arange(16)[None, :] < np.array([[12], [5]]),
    }
    noise = torch.from_numpy(rng.standard_normal((2, 4, 7)).astype(np.float32))
    ref = cpu.sample_actions(CoTObservation.from_dict(batch, device="cpu"), noise=noise)
    got = gpu.sample_actions(CoTObservation.from_dict(batch, device=device), noise=noise)
    err = (got.cpu() - ref).abs().max().item()
    log(f"small reference: dummy LAP f32 card vs CPU max_abs_err={err:.3e} (tol {SMALL_REF_TOL})")
    if not err <= SMALL_REF_TOL:
        raise AssertionError(f"card and CPU disagree on the dummy model: {err}")


def log_unported_kernel_bounds() -> None:
    """Bounds of the two TPU kernels still to be ported (weight-only int8 and
    int4 dequant matmuls of quantized serving), from their shapes alone: no
    kernel exists yet and nothing is timed. The JAX package calls them for
    decode-shaped rows (at most 128; 16 flow-suffix rows or 1 AR token) on
    gemma_2b weights of at least 4 Mi elements; int4 scales are per group of
    256 contraction rows. x and out are bf16, scales f32; the products run
    in bf16 after the dequantisation, so the bf16 peak applies."""
    shapes = {"mlp_down": (16384, 2048), "mlp_gate_up": (2048, 32768), "vocab": (2048, 257152)}
    for rows in (1, 16):
        for name, (k, n) in shapes.items():
            flops_ms = 2 * rows * k * n / PEAK_BF16_FLOPS * 1e3
            act_bytes = rows * k * 2 + rows * n * 2
            for kind, nbytes in (
                ("int8_matmul", act_bytes + k * n + n * 4),
                ("int4_matmul", act_bytes + k * n // 2 + (k // 256) * n * 4),
            ):
                bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                log(f"bound (not ported, nothing timed): {kind} {name} M={rows} K={k} N={n}: "
                    f"bound_ms={max(flops_ms, bytes_ms):.5f} by {'operations' if flops_ms >= bytes_ms else 'bytes'} "
                    f"(bytes={nbytes} -> {bytes_ms:.5f} ms, flops={2 * rows * k * n} -> {flops_ms:.5f} ms)")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def check_small_train_reference(device) -> None:
    """One loss-and-gradient pass of the dummy-size lap-like model in f32 on
    the card against the CPU with the same weights, batch, noise and time
    (the CPU path is what the tests hold against the JAX package)."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.lap_model import LAP, LAPConfig
    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.training.optimizer import global_norm

    config = LAPConfig(
        dtype="float32", paligemma_variant="dummy", action_expert_variant="dummy",
        siglip_variant="dummy", action_horizon=4, max_token_len=16, image_resolution=(28, 28),
        enable_action_training=True, stop_action_to_vlm_grad=True,
    )
    cpu = LAP(config, device="cpu", init_seed=0)
    gpu = LAP(config, device=device, init_seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(11)
    batch = {
        "image": {k: rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8) for k in config.image_keys},
        "state": rng.standard_normal((2, 7)).astype(np.float32),
        "tokenized_prompt": rng.integers(0, 257_152, (2, 16)).astype(np.int32),
        "tokenized_prompt_mask": np.arange(16)[None, :] < np.array([[14], [9]]),
        "tokenized_langact_mask": np.broadcast_to(np.arange(16) >= 4, (2, 16)).copy(),
        "token_loss_mask": np.ones((2, 16), bool),
    }
    actions = torch.from_numpy(rng.standard_normal((2, 4, 7)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 7)).astype(np.float32))
    time_ = torch.tensor([0.3, 0.8])
    results = []
    for model, dev in ((cpu, "cpu"), (gpu, device)):
        loss, _ = model.compute_loss(
            CoTObservation.from_dict(batch, device=dev), actions.to(dev), noise=noise.to(dev), time=time_.to(dev)
        )
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        # Each device takes its own branch of global_norm.
        results.append((loss.item(), {n: g.cpu() for n, g in grads.items()}, global_norm(grads.values()).item()))
    (ref_loss, ref_grads, ref_norm), (got_loss, got_grads, got_norm) = results
    loss_err = abs(got_loss - ref_loss) / abs(ref_loss)
    norm_err = abs(got_norm - ref_norm) / abs(ref_norm)
    if set(ref_grads) != set(got_grads):
        raise AssertionError("card and CPU give gradients to different parameters")
    worst, worst_name = 0.0, ""
    for name, ref in ref_grads.items():
        # A leaf whose gradient is zero in exact arithmetic (a SigLIP key bias:
        # the softmax does not see it) holds rounding noise only: floor 1e-6.
        err = ((got_grads[name] - ref).abs().max() / (ref.abs().max() + 1e-6 / SMALL_TRAIN_TOL)).item()
        if err > worst:
            worst, worst_name = err, name
    log(
        f"small reference: dummy LAP f32 training pass card vs CPU loss {got_loss:.6f} vs {ref_loss:.6f} "
        f"(rel {loss_err:.3e}); worst of {len(ref_grads)} gradient leaves {worst:.3e} of its max "
        f"({worst_name}); global gradient norm {got_norm:.6f} vs {ref_norm:.6f} (rel {norm_err:.3e}) "
        f"(tol {SMALL_TRAIN_TOL})"
    )
    if not (loss_err <= SMALL_TRAIN_TOL and worst <= SMALL_TRAIN_TOL and norm_err <= SMALL_TRAIN_TOL):
        raise AssertionError("card and CPU disagree on the dummy training pass")


def profile_one_step(trainer, batch) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.run(batch, 1)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    report_profile(prof, "training step", wall_ms)


def loss_and_grad_norm(trainer, batch, noise, time_):
    """One forward and backward without an optimizer step."""
    import torch

    from lap_tpu_torch.training.optimizer import global_norm

    loss, _ = trainer.model.compute_loss(*batch, train=False, noise=noise, time=time_)
    loss.backward()
    params = [p for p in trainer.model.parameters() if p.grad is not None]
    norm = global_norm([p.grad for p in params]).item()
    # The same gradients summed in float64, one tensor at a time.
    squares = sum(torch.linalg.vector_norm(p.grad, dtype=torch.float64).square() for p in params)
    norm_f64 = squares.sqrt().item()
    for p in params:
        p.grad = None
    torch.cuda.synchronize()
    rel = abs(norm - norm_f64) / norm_f64
    log(f"path: global gradient norm over {len(params)} tensors, float32 fused {norm:.6f} vs float64 {norm_f64:.6f} "
        f"(rel {rel:.3e}, tol {NORM_REL_TOL})")
    if not rel <= NORM_REL_TOL:
        raise AssertionError("the card's global norm disagrees with float64 accumulation")
    return loss.item(), norm


def build_training(device):
    """The full-width trainer at the config's defaults (float32 parameters,
    EMA on) and the first step, which allocates everything a step needs. A
    card too small for it fails here with PyTorch's out-of-memory error."""
    import dataclasses

    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.config import get_config
    from lap_tpu_torch.training.optimizer import CosineDecaySchedule

    base = get_config("lap")
    # The published schedule warms up over 5,000 steps from lr 2e-8, too slow
    # to show in a handful of steps: the warm-up is cut to the length of this
    # run (same peak), so the lr climbs from 9e-6 towards 1e-4 as it goes.
    sched = base.lr_schedule
    warmup = TRAIN_WARMUP_STEPS + TRAIN_STEPS + 2
    config = dataclasses.replace(
        base, lr_schedule=CosineDecaySchedule(warmup_steps=warmup, peak_lr=sched.peak_lr,
                                              decay_steps=sched.decay_steps, decay_lr=sched.decay_lr),
    )
    t0 = time.monotonic()
    trainer = port_train.build_trainer(config, device=device)
    batch = port_train.fake_train_batch(config.model, TRAIN_BATCH, device=device, seed=config.seed)
    trainer.run(batch, 1)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"training: built LAP-3B trainer ({n_params} params in {config.param_dtype}, bf16 activations, "
        f"EMA {'on' if trainer.state.ema_params is not None else 'off'}, per-device batch {TRAIN_BATCH}) "
        f"and took the first step in {time.monotonic() - t0:.1f} s")
    return trainer, batch


def run_training(device):
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    trainer, batch = build_training(device)
    batch_size, param_dtype = TRAIN_BATCH, trainer.config.param_dtype
    config = trainer.config.model
    trainer.run(batch, TRAIN_WARMUP_STEPS - 1)

    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    torch.cuda.reset_peak_memory_stats()
    records, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        records += trainer.run(batch, 1)
        per_step.append(tuple(a - b for a, b in zip((fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv), before)))
    launches = dict(fwd=fa.launches, dq=fa.launches_bwd_dq, dkv=fa.launches_bwd_dkv)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"training: launches per step (fwd, dq, dkv) {per_step} (totals {launches})")
    depth = len(trainer.model.llm.layers)
    if any(c != (2 * depth, depth, depth) for c in per_step):
        raise AssertionError(f"expected {(2 * depth, depth, depth)} launches per step, got {per_step}")
    losses = [r["loss"] for r in records]
    norms = [r["grad_norm"] for r in records]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on the fixed batch: {losses}")
    step_ms = [r["step_ms"] for r in records]
    log(
        f"training: {TRAIN_STEPS} steps after {TRAIN_WARMUP_STEPS} warm-up at batch {batch_size} ({param_dtype} params) "
        f"loss={[round(x, 4) for x in losses]} grad_norm={[round(x, 4) for x in norms]} "
        f"step_ms_median={statistics.median(step_ms):.3f} step_ms={[round(x, 1) for x in step_ms]} "
        f"samples_per_s={batch_size * 1000.0 / statistics.median(step_ms):.3f} peak_mem_gib={peak_gib:.2f}"
    )

    # Kernels vs einsum attention: one loss-and-gradient pass each, same
    # weights, batch, noise and time.
    gen = torch.Generator(device=device).manual_seed(9)
    noise = torch.randn((batch_size, config.action_horizon, config.action_dim), generator=gen, device=device)
    time_ = torch.rand((batch_size,), generator=gen, device=device) * 0.999 + 0.001
    counted = fa.launches_bwd_dq
    loss_k, norm_k = loss_and_grad_norm(trainer, batch, noise, time_)
    if fa.launches_bwd_dq == counted:
        raise AssertionError("the comparison pass did not go through the backward kernels")
    trainer.model.set_attn_impl("xla")
    counted = fa.launches_bwd_dq
    loss_x, norm_x = loss_and_grad_norm(trainer, batch, noise, time_)
    if fa.launches_bwd_dq != counted:
        raise AssertionError("the einsum pass launched a flash kernel")
    trainer.model.set_attn_impl(config.attn_impl)
    loss_rel, norm_rel = abs(loss_k - loss_x) / abs(loss_x), abs(norm_k - norm_x) / abs(norm_x)
    log(
        f"path: training pass flash kernels vs xla attention loss {loss_k:.6f} vs {loss_x:.6f} "
        f"(rel {loss_rel:.3e}, tol {TRAIN_LOSS_REL_TOL}); grad_norm {norm_k:.6f} vs {norm_x:.6f} "
        f"(rel {norm_rel:.3e}, tol {TRAIN_GRAD_NORM_REL_TOL})"
    )
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and norm_rel <= TRAIN_GRAD_NORM_REL_TOL):
        raise AssertionError("flash and xla training passes differ beyond tolerance")

    profile_one_step(trainer, batch)
    return launches


def main() -> int:

    if not (REPO / "lap_tpu_torch" / "csrc").is_dir():
        return fail(f"no lap_tpu_torch package beside {Path(__file__).name}")
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from lap_tpu_torch import cuda_build
    from lap_tpu_torch.ops import flash_attention as fa

    t0 = time.monotonic()
    sources = (fa.SOURCE, fa.BWD_SOURCE)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # nvcc runs as a subprocess
        list(pool.map(cuda_build.build, sources))
    log(f"build: {', '.join(sources)} in {time.monotonic() - t0:.1f} s (one nvcc each, in parallel)")
    for source in sources:
        for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build: {source}: {line.strip()}")

    max_err = check_flash_kernel(device)
    bwd_err = check_flash_backward(device)
    timing = time_flash_kernel(device)
    check_small_reference(device)
    check_small_train_reference(device)
    serving_launches = run_policy(device)
    torch.cuda.empty_cache()
    train_launches = run_training(device)
    torch.cuda.empty_cache()
    bwd_timing = time_flash_backward(device, TRAIN_BATCH)
    log_unported_kernel_bounds()

    csrc = "lap_tpu_torch/csrc/"
    kernels = [
        dict(
            name="flash_attention_fwd", route="cuda", source=csrc + fa.SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:53",
            launches=serving_launches + train_launches["fwd"],
            launches_serving=serving_launches, launches_training=train_launches["fwd"],
            max_abs_err=max(max_err, bwd_err["fwd"]), **timing,
        ),
        dict(
            name="flash_attention_bwd_dq", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:173", launches=train_launches["dq"],
            max_abs_err=bwd_err["dq"], **bwd_timing["dq"],
        ),
        dict(
            name="flash_attention_bwd_dkv", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:215", launches=train_launches["dkv"],
            max_abs_err=bwd_err["dkv"], **bwd_timing["dkv"],
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
