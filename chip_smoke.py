#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Four paths are driven: LAP-3B flow-matching serving in bf16 (phase 6) and
with int8/int4 expert MLPs (phase 7), LAP-3B AR language-action serving in
bf16, int8 and int4 (phase 8), and the LAP-3B training step (phases 10-11).
Each is driven with the launch counters set to 0 just before it and read
just after. Phases, in order; any failure exits non-zero:
 1. build every CUDA kernel of the paths from the sources in this checkout
    (``lap_tpu_torch/csrc/``, into ``lap_tpu_torch/_build/``), one ``nvcc``
    per source, in parallel;
 2. hold each kernel (the flash forward; the backward's delta, dQ, dK/dV and
    GQA group-sum kernels; the int8 and int4 dequant matmuls) against its
    plain PyTorch version on the card, on the paths' shapes and edge cases,
    with the tolerances stated below; the forward at batch 1 on the flow
    prefix and the right-aligned AR prefill (leading dead rows, 64 masked
    decode slots), and two forward calls at the prefill and the training
    call must give the same bits; the training call
    is held at the path's batch and with the strides the model gives it (q
    and the mask are the first 692 rows of the joint 708-row tensors),
    forward (out, lse) and backward, and two backward calls there and at GQA
    group 4 must give the same bits; the dequant matmuls at 1, 16, 100 and
    128 rows for every quantized weight shape, two calls giving the same
    bits at each, and their split-K arrival counters back at zero after all
    the calls; print the forward's and the backward kernels' registers,
    spills, resident blocks per SM and waves beside their plans, and the
    dequant kernels' beside their launch plan;
 3. time each kernel, its plain version and one PyTorch library call that
    computes the same function (a yardstick the port never calls), beside the
    least time the card could take (``bound_ms``); the dequant matmuls (every
    quantized shape at the rows its path gives it, the three largest at 16
    rows too, and MLP gate/up at 100 and 128 rows), the delta kernel and the
    group-sum pass by their device time, the flash forward at the serving
    prefill by CUDA events around a loop of calls (``ms``; at batch 1 that
    is the host's time to launch a call) and by its device time
    (``device_ms``), and the flash kernels last, at the batch the training
    path ran with: the forward beside SDPA's forward (both ways), each
    backward kernel alone and the whole ``flash_attention_backward`` as the
    path calls it, beside autograd through
    ``F.scaled_dot_product_attention``;
 4. run the dummy-size model in f32 on the card and on the CPU with the same
    weights (the CPU path is what the tests hold against the JAX package):
    ``sample_actions``, AR ``sample_tokens``, and one training pass (loss,
    every gradient leaf and the global gradient norm);
 5. build the full-width LAP-3B policy (gemma_2b + gemma_300m + SigLIP
    So400m/14, bf16) on the card from seeded random weights;
 6. flow serving: requests through ``Policy.infer`` (18 flash launches
    each), ``sample_actions`` with ``attn_impl="flash"`` against
    ``attn_impl="xla"``, latency (p50, p90 over ``N_REQUESTS`` closed-loop
    requests at batch 1) and one profiled request;
 7. quantized flow serving: int8, then int4 copies of the decode weights;
    per request 360 dequant launches (18 expert MLPs x 2 matmuls x 10 Euler
    steps) and 18 flash launches; actions against bf16, for information;
 8. AR serving: ``ARPolicy`` at batch 1 decoding ``AR_STEPS`` tokens, in bf16,
    int8 and int4: per request 18 flash launches (the 692-row prefill) and,
    quantized, 73 * AR_STEPS + 1 dequant launches (18 layers x 4 matmuls + the
    vocab head per step, plus the first logits); latency per request and per
    token, the prefill alone, and one profiled request per mode, which must
    hold exactly one dequant kernel per dequant call;
 9. quantized AR logits with the kernels against the same model with the
    plain versions, teacher-forced, and the quantized-vs-bf16 difference of
    the first logits (information);
10. build the full-width LAP-3B trainer (the ``lap`` config: float32
    parameters under bf16 activations, AdamW, EMA, stop-gradient, per-layer
    rematerialisation) from seeded random weights and take optimizer steps on
    the synthetic batch: per step 36 forward (18 layers, run again by the
    rematerialisation), 18 delta, 18 dQ, 18 dK/dV and, with GQA groups, 18
    group-sum launches; the loss is finite and falls; step time, peak
    memory, and one profiled step with its device time summed by kernel
    family over every kernel;
11. compare one loss-and-gradient pass with the kernels against one with
    ``attn_impl="xla"`` from the same weights, batch, noise and time, and the
    float32 global gradient norm against a float64 sum over the same
    gradients.

The serving model is freed before the training phase. The last lines of
standard output are the ``kernels`` JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": ...}``. The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
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
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
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

# Dequant matmuls against their plain versions on the card: the plain
# version is taken in f32 on the same bf16 x, the kernel rounds its f32 sum
# to bf16 once: one bf16 rounding plus the summation order.
QUANT_RTOL, QUANT_ATOL_OF_MAX = 8e-3, 1e-4
QUANT_ROWS = (1, 16, 100, 128)
# (name, K, N) of every quantized weight of LAP-3B serving.
QUANT_SHAPES = (
    ("q_attn_vec", 2048, 2048), ("mlp_gate_up", 2048, 32768), ("mlp_down", 16384, 2048),
    ("vocab", 2048, 257152), ("expert_gate_up", 1024, 8192), ("expert_down", 4096, 1024),
)
# (shape, rows) timed: every quantized shape at the rows its path gives it
# (AR steps: 1 row; the flow expert: 16 rows), the three largest at 16 rows
# too, and 100 and 128 rows once (QUANT_MAX_ROWS routes up to 128 rows to
# the kernels).
QUANT_TIMED = (
    ("mlp_down", 1), ("mlp_down", 16), ("mlp_gate_up", 1), ("mlp_gate_up", 16), ("vocab", 1), ("vocab", 16),
    ("q_attn_vec", 1), ("expert_gate_up", 16), ("expert_down", 16), ("mlp_gate_up", 100), ("mlp_gate_up", 128),
)
# The shape whose times stand in the kernels JSON line: the vocab head of an
# AR step, the largest weight read of a decode step.
QUANT_JSON_SHAPE = ("vocab", 1)
# Operand copies cycled through when timing, at least this many bytes, so
# that each call finds its weight out of the 50 MB L2 as a decode step does.
COLD_BYTES = 256e6
# Share of a profiled AR request's kernels the trace must keep: the profiler
# may drop a few events at the ends of a trace (10 of 4,673 dequant kernels
# once on an H100, and a few of every other family in the same trace).
PROFILE_KEPT_SHARE = 0.99
# A profile idles this long on the host before and after its calls: the
# profiler keeps only the device events that fall inside its window, and one
# short timing profile on an H100 once kept none (a dequant time of 0).
PROFILE_PAD_S = 0.01
# A profile that holds no device event is taken again, at most this often.
PROFILE_ATTEMPTS = 3
# AR serving at batch 1: a fixed budget and no EOS stop, so the work does not
# depend on what random weights emit.
AR_STEPS = 64
AR_REQUESTS = 5
QUANT_FLOW_REQUESTS = 4
# Quantized AR logits with the kernels against the same model with the plain
# versions, teacher-forced over the first AR_FORCED_STEPS steps, relative L2.
# One bf16 rounding that lands on the other side (a different f32 summation
# order) changes every later bf16 rounding of the decode step, and 18
# random-weight layers carry that to ~1e-2 of the logits: the plain version
# against itself with float64 sums moves them as far (measured 1.01e-2
# int8, 1.08e-2 int4 on an H100). So the logits must come within
# AR_FLOOR_FACTOR of that floor, measured in the same run, and every dequant
# call of the pass within the kernel check's tolerance of the plain version
# on the same input.
AR_FORCED_STEPS = 8
AR_KERNEL_REL_TOL = 1e-2  # the target, reported beside the floor
AR_FLOOR_FACTOR = 1.5
# The dummy model's AR decode on the card against the CPU: its embedding
# table is scaled up so that no two logits of a step are near-tied.
SMALL_AR_STEPS = 8

# Closed loop, one client, batch 1: p90 has three beyond it.
N_REQUESTS = 30
TRAIN_BATCH = 8  # per device; float32 parameters and EMA fit an 80 GB card at this batch
TRAIN_WARMUP_STEPS, TRAIN_STEPS = 2, 6
LAP_PREFIX = 2 * 256 + 180  # two 224^2 cameras at patch 14, plus the prompt
PROMPT_LEN, PROMPT_VALID = 180, 40
ACTION_HORIZON = 16
LANGACT_START = 8  # first language-action slot of the synthetic training prompt
TRAINING_CASE = "training_step"  # the kernel case with the training path's shape, batch and strides
PREFILL_CASE = "path_prefix_lm"  # the kernel case of the serving prefill (flow prefix mask)
# Forward cases run twice to show that two calls give the same bits.
FWD_DETERMINISM_CASES = (PREFILL_CASE, TRAINING_CASE)
# Backward cases run twice to show that two calls give the same bits.
DETERMINISM_CASES = (TRAINING_CASE, "gqa_group4_h128")


_START = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - _START:7.1f}s] {msg}", flush=True)


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


def ar_prefill_mask(device):
    """The mask of the AR prefill as ``LAP.ar_prefill`` passes it: the
    prefix-LM mask right-aligned (the 140 padding rows and keys first, all
    masked) and padded with ``AR_STEPS`` masked decode slots, [1, 692, 756]."""
    import torch

    from lap_tpu_torch.models.lap_model import left_to_right_align

    valid = 512 + PROMPT_VALID
    mask = prefix_lm_mask([valid], [0], LAP_PREFIX, device)
    input_mask = torch.arange(LAP_PREFIX, device=device)[None] < valid
    x = torch.zeros((1, LAP_PREFIX, 1), device=device)
    _, _, aligned = left_to_right_align(x, input_mask, mask)
    return torch.nn.functional.pad(aligned, (0, AR_STEPS))


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
        (PREFILL_CASE, (1, LAP_PREFIX, LAP_PREFIX, 8, 1, 256), path_mask),
        ("ar_prefill_right_aligned", (1, LAP_PREFIX, LAP_PREFIX + AR_STEPS, 8, 1, 256), ar_prefill_mask(device)),
        ("b2_unequal_padding", (2, 300, 300, 8, 1, 256), prefix_lm_mask([250, 180], [30, 12], 300, device)),
        ("gqa_k2", (1, 256, 256, 8, 2, 256), rand_mask(1, 256, 256, 0.7)),
        ("gqa_k8", (1, 200, 200, 8, 8, 256), rand_mask(1, 200, 200, 0.7)),
        ("head_dim_128", (1, 384, 384, 8, 1, 128), prefix_lm_mask([300], [20], 384, device)),
        ("fully_masked_rows", (1, 257, 257, 8, 1, 256), rand_mask(1, 257, 257, 0.5, dead_rows=40)),
        ("ragged_t_s", (1, 100, 333, 4, 1, 256), rand_mask(1, 100, 333, 0.5)),
    ]


def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check_forward(name, q, k, v, mask, out, lse) -> float:
    """The forward kernel's ``out`` and ``lse`` against the plain version;
    a case in ``FWD_DETERMINISM_CASES`` is run again and must give the same
    bits."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    (b, t, n, h), s, kh = q.shape, k.shape[1], k.shape[2]
    plan = fa.forward_plan(b, t, s, n, kh, h, sm_count(q.device))
    if name in FWD_DETERMINISM_CASES:
        again = fa.flash_attention_forward(q, k, v, mask)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"{name}: two forward calls gave different bits")
        log(f"kernel flash_attention_fwd case={name}: two calls give the same bits (out, lse)")
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    err = (out.float() - ref_out.float()).abs()
    bound = OUT_ATOL + OUT_RTOL * ref_out.float().abs()
    lse_err = (lse - ref_lse).abs().max().item()
    dead = ~mask.any(dim=-1)  # [B, T]
    log(
        f"kernel flash_attention_fwd case={name} shape=B{b} T{t} S{s} N{n} K{kh} H{h} "
        f"grid={plan['grid']} "
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
    if dead.any() and not bool((lse.transpose(1, 2)[dead] == fa.MASK_VALUE).all()):
        raise AssertionError(f"{name}: the lse of fully masked rows is not {fa.MASK_VALUE}")
    return err.max().item()


def forward_occupancy(device):
    """Registers, spills, resident blocks per SM and waves of the forward
    kernel at the serving prefill and the training shape, from the compiled
    kernel on this card, beside the launch plan."""
    from lap_tpu_torch.ops import flash_attention as fa

    sms = sm_count(device)
    info = fa.forward_info(256)
    result = {}
    for name, shape in (("prefill", (1, LAP_PREFIX, LAP_PREFIX, 8, 1, 256)),
                        ("training", (TRAIN_BATCH, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256))):
        plan = fa.forward_plan(*shape, sms)
        waves = plan["blocks"] / (sms * info["blocks_per_sm"]) if info["blocks_per_sm"] else math.inf
        result[name] = dict(info, blocks=plan["blocks"], waves=waves)
        log(f"occupancy flash_attention_fwd {name} H256: registers={info['registers']} (entry; setmaxnreg gives "
            f"the consumers more) spill_bytes={info['local_bytes']} smem={info['smem']} (plan {plan['smem']}) "
            f"blocks_per_sm={info['blocks_per_sm']} (plan {plan['blocks_per_sm']}) threads={plan['threads']} "
            f"grid={plan['grid']} ({plan['blocks']} blocks) waves={waves:.3f} on {sms} SMs")
        if info["smem"] != plan["smem"] or info["blocks_per_sm"] < plan["blocks_per_sm"]:
            raise AssertionError(f"the forward's launch plan disagrees with the compiled kernel: {info} {plan}")
    return result


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
    # The device time of the call's kernels (profiler): at batch 1 the host
    # takes longer to launch a call than the card to run it, and CUDA events
    # around a loop of calls time the host.
    device_ms = device_ms_per_call([lambda: fa.flash_attention_forward(q, k, v, mask)], iters=50)
    plain_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, mask), iters=10)
    # Yardstick only: one PyTorch call computing the same attention.
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa_mask = mask[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True)

    library_ms = time_cuda(sdpa)
    library_device_ms = device_ms_per_call([sdpa], iters=50)
    bound_ms, bound_by, flops_ms, bytes_ms = flash_forward_bound(mask, q, k, v)
    log(
        f"timing flash_attention_fwd B{b} T=S={t} N{n} K{kh} H{h}: kernel_ms={kernel_ms:.5f} "
        f"(device time {device_ms:.5f}) plain_ms={plain_ms:.5f} library_ms(sdpa)={library_ms:.5f} "
        f"(device time {library_device_ms:.5f}) bound_ms={bound_ms:.5f} "
        f"(flops -> {flops_ms:.5f} ms, bytes -> {bytes_ms:.5f} ms; dense flops {4 * n * h * t * t})"
    )
    return dict(
        ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by,
    )


def flash_forward_bound(mask, q, k, v):
    """Least time for one forward call, (ms, "operations" or "bytes",
    flops_ms, bytes_ms): only the unmasked (query, key) pairs need the two
    products, 4 N H flops a pair at 989 TFLOP/s (bf16); the bytes are q, k,
    v and the mask read once, out and lse written once, at 3.35 TB/s."""
    (b, t, n, h), pairs = q.shape, int(mask.sum())
    flops_ms = 4 * n * h * pairs / PEAK_BF16_FLOPS * 1e3
    nbytes = 2 * q.numel() * 2 + k.numel() * 2 + v.numel() * 2 + mask.numel() + b * n * t * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes", flops_ms, bytes_ms


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


def check_delta(name, out, dout) -> float:
    """The delta kernel against its plain version: the same f32 products
    summed in other orders, each side within (H - 1) ulps of sum |dO * O|."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    delta = fa.flash_attention_delta(out, dout)
    torch.cuda.synchronize()
    ref = fa.flash_attention_delta_plain(out, dout)
    h = out.shape[-1]
    bound = 2 * (h - 1) * 2.0**-24 * (dout.float() * out.float()).abs().sum(-1).transpose(1, 2)
    err = (delta - ref).abs()
    log(f"kernel flash_attention_bwd_delta case={name} max_abs_err={err.max().item():.3e} "
        f"(bound 2 (H - 1) f32 ulps of sum|dO*O|, at least {bound.min().item():.3e})")
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: delta differs beyond the f32 summation bound")
    return err.max().item()


def check_group_sum(name, shape, generator) -> float:
    """The group-sum pass against its plain version on random f32 partials of
    the case's scratch shape: the same additions in the same order, so the
    same bits."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    b, s, n, kh, h = shape
    partial = torch.randn((2, b, s, n, h), generator=generator, device=generator.device)
    got = fa.flash_attention_group_sum(partial, kh)
    torch.cuda.synchronize()
    ref = fa.flash_attention_group_sum_plain(partial, kh)
    err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref, strict=True))
    log(f"kernel flash_attention_bwd_group_sum case={name} group={n // kh} max_abs_err={err:.3e} (must be 0)")
    if err != 0.0:
        raise AssertionError(f"{name}: the group-sum pass differs from its plain version")
    return err


def check_flash_backward(device):
    """dQ, dK, dV of the two backward kernels against the plain backward, on
    the forward kernel's own out and lse, which are held against the plain
    forward first (the only place the forward sees S = 708)."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(4)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "delta": 0.0, "group_sum": 0.0}
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
        worst["delta"] = max(worst["delta"], check_delta(name, out, dout))
        if name in DETERMINISM_CASES:
            again = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(grads, again, strict=True)):
                raise AssertionError(f"{name}: two backward calls gave different bits")
            log(f"kernel flash_attention_bwd case={name}: two calls give the same bits (dq, dk, dv)")
        if n > kh:
            worst["group_sum"] = max(worst["group_sum"], check_group_sum(name, (b, s, n, kh, h), g))
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


def backward_occupancy(batch):
    """Registers, spills, resident blocks per SM and waves of the dQ and dK/dV
    kernels at the training shape, from the compiled kernels on this card."""
    import torch

    from lap_tpu_torch.ops import flash_attention as fa

    b, t, s, n, kh, h = batch, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256
    plan = fa.backward_plan(b, t, s, n, kh, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for name, info in fa.backward_info(h).items():
        blocks = math.prod(plan[name + "_grid"])
        waves = blocks / (sms * info["blocks_per_sm"]) if info["blocks_per_sm"] else math.inf
        result[name] = dict(info, blocks=blocks, waves=waves)
        log(f"occupancy flash_attention_bwd_{name} H{h}: registers={info['registers']} "
            f"spill_bytes={info['local_bytes']} smem={info['smem']} blocks_per_sm={info['blocks_per_sm']} "
            f"grid={plan[name + '_grid']} ({blocks} blocks) waves={waves:.3f} on {sms} SMs")
    return result


def time_flash_backward(device, batch):
    """The backward at the training shape: the delta kernel, the dQ kernel and
    the dK/dV kernel with its group-sum pass each alone (from a given delta;
    CUDA events, except the delta kernel and the pass: profiler device time),
    the pass alone, and the whole ``flash_attention_backward`` as the path
    calls it (the output gradient's copy, delta once, dQ, dK/dV and the pass),
    beside their bounds, the plain versions and autograd through
    ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(5)
    b, t, s, n, kh, h = batch, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256
    mask = training_mask(b, device)
    q = training_queries(b, g, device)
    k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
    dout = training_queries(b, g, device)  # a slice of the joint tensor, as on the path
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    scale = h**-0.5
    dout_c = dout.contiguous()
    delta = fa.flash_attention_delta(out, dout_c)
    plan = fa.backward_plan(b, t, s, n, kh, h)
    partial = torch.randn(plan["scratch_shape"], generator=g, device=device)

    def grads(**need):
        return fa.flash_attention_backward_kernels(q, k, v, mask, lse, dout_c, delta, scale=scale, **need)

    # delta and the pass take the card less time than the host takes to launch
    # them: their device time from the profiler, as for the dequant kernels.
    delta_ms = device_ms_per_call([lambda: fa.flash_attention_delta(out, dout_c)], iters=50)
    dq_ms = time_cuda(lambda: grads(need_dq=True, need_dkv=False), iters=20)
    dkv_ms = time_cuda(lambda: grads(need_dq=False, need_dkv=True), iters=20)
    group_sum_ms = device_ms_per_call([lambda: fa.flash_attention_group_sum(partial, kh)], iters=50)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    pair_ms = time_cuda(
        lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, dout, scale=scale), iters=20
    )
    pair_peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    # The forward at this shape (CUDA events, and device time), beside one
    # PyTorch call computing the same attention (a yardstick only).
    fwd_ms = time_cuda(lambda: fa.flash_attention_forward(q, k, v, mask), iters=20)
    fwd_device_ms = device_ms_per_call([lambda: fa.flash_attention_forward(q, k, v, mask)], iters=20)
    qt_fwd, kt_fwd, vt_fwd = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa_forward():
        return F.scaled_dot_product_attention(qt_fwd, kt_fwd, vt_fwd, attn_mask=mask[:, None], enable_gqa=True)

    fwd_library_ms = time_cuda(sdpa_forward, iters=20)
    fwd_library_device_ms = device_ms_per_call([sdpa_forward], iters=20)
    plain_ms = time_cuda(
        lambda: fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout, scale),
        iters=3, reps=3, warmup=1,
    )
    delta_plain_ms = time_cuda(lambda: fa.flash_attention_delta_plain(out, dout_c), iters=20)
    group_sum_plain_ms = time_cuda(lambda: fa.flash_attention_group_sum_plain(partial, kh), iters=20)
    # Yardstick only: torch.sum over the group axis of the same f32 partials (f32 out).
    grouped = partial.view(2, b, s, kh, n // kh, h)
    group_sum_library_ms = device_ms_per_call([lambda: torch.sum(grouped, dim=4)], iters=50)
    # Yardstick only: autograd through one PyTorch call, dq, dk and dv together.
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).detach().requires_grad_()
    vt = v.transpose(1, 2).detach().requires_grad_()
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    library_ms = time_cuda(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), iters=20
    )

    def bound(flops, peak, nbytes):
        flops_ms = flops / peak * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        return max(flops_ms, bytes_ms), ("operations" if flops_ms >= bytes_ms else "bytes"), flops_ms, bytes_ms

    pairs = int(mask.sum())
    row_bytes = 2 * b * n * t * 4  # lse and delta
    in_bytes = 2 * q.numel() * 2 + k.numel() * 2 + v.numel() * 2 + mask.numel() + row_bytes
    results = {}
    for name, ms, plain, flops, peak, nbytes in (
        ("dq", dq_ms, plain_ms, 2 * 3 * n * h * pairs, PEAK_BF16_FLOPS, in_bytes + q.numel() * 2),
        ("dkv", dkv_ms, plain_ms, 2 * 4 * n * h * pairs, PEAK_BF16_FLOPS, in_bytes + 2 * k.numel() * 2),
        # delta: dO and O read, [B, N, T] f32 written; f32 products and sums off the tensor cores.
        ("delta", delta_ms, delta_plain_ms, 2 * q.numel(), PEAK_F32_FLOPS, 2 * q.numel() * 2 + b * n * t * 4),
        # group sum: the f32 partials read, bf16 dK and dV written; G - 1 adds per output.
        ("group_sum", group_sum_ms, group_sum_plain_ms, 2 * k.numel() * (n // kh - 1), PEAK_F32_FLOPS,
         partial.numel() * 4 + 2 * k.numel() * 2),
    ):
        bound_ms, bound_by, flops_ms, bytes_ms = bound(flops, peak, nbytes)
        library = group_sum_library_ms if name == "group_sum" else None  # torch.sum over the group axis
        results[name] = dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound_ms, bound_by=bound_by,
                             batch=b)
        log(
            f"timing flash_attention_bwd_{name} B{b} T{t} S{s} N{n} K{kh} H{h}: kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bound_ms:.5f} (flops={flops} -> {flops_ms:.5f} ms, "
            f"bytes={nbytes} -> {bytes_ms:.5f} ms) library_ms={library}"
        )
    for name in ("dq", "dkv"):
        # The plain backward and the library call each give dq, dk and dv at once.
        results[name].update(library_ms=library_ms, plain_and_library_cover="dq+dkv", pair_ms=pair_ms)
    results["dkv"]["includes"] = "the group-sum pass"
    fwd_bound_ms, fwd_bound_by, fwd_flops_ms, fwd_bytes_ms = flash_forward_bound(mask, q, k, v)
    results["fwd"] = dict(ms=fwd_ms, device_ms=fwd_device_ms, library_ms=fwd_library_ms,
                          library_device_ms=fwd_library_device_ms, bound_ms=fwd_bound_ms, bound_by=fwd_bound_by,
                          batch=b)
    log(f"timing flash_attention_fwd B{b} T{t} S{s} N{n} K{kh} H{h} (training shape, strided): "
        f"kernel_ms={fwd_ms:.5f} (device time {fwd_device_ms:.5f}) library_ms(sdpa forward)={fwd_library_ms:.5f} "
        f"(device time {fwd_library_device_ms:.5f}) bound_ms={fwd_bound_ms:.5f} ({fwd_bound_by}: "
        f"flops {4 * n * h * pairs} -> {fwd_flops_ms:.5f} ms, bytes -> {fwd_bytes_ms:.5f} ms)")
    log(
        f"timing flash_attention_bwd B{b}: pair as the path calls it (dO copy, delta once, dq, dkv, pass) "
        f"kernel_ms={pair_ms:.5f} vs library_ms(sdpa backward, dq, dk, dv together)={library_ms:.5f} "
        f"(ratio {pair_ms / library_ms:.3f}); parts delta {delta_ms:.5f} + dq {dq_ms:.5f} + dkv with pass "
        f"{dkv_ms:.5f} (pass {group_sum_ms:.5f}) = {delta_ms + dq_ms + dkv_ms:.5f}; "
        f"plain_ms(dq, dk, dv together)={plain_ms:.5f}; "
        f"peak memory of one call above its inputs {pair_peak_mib:.1f} MiB "
        f"(group-sum scratch {partial.numel() * 4 / 2**20:.1f} MiB)"
    )
    return results


# ---------------------------------------------------------------------------
# Dequant matmuls
# ---------------------------------------------------------------------------


def quant_kinds():
    """(name, module, quantize, kernel wrapper, plain version) of each dequant matmul."""
    from lap_tpu_torch.ops import int4_matmul as i4
    from lap_tpu_torch.ops import int8_matmul as i8

    return (
        ("int8_matmul", i8, i8.quantize_int8, i8.int8_matmul, i8.int8_matmul_plain),
        ("int4_matmul", i4, i4.quantize_int4, i4.int4_matmul, i4.int4_matmul_plain),
    )


def dequant_kernel_info() -> None:
    """Registers, spills, shared memory and resident blocks per SM of each
    compiled dequant kernel (8 and 16 rows a tile), beside the wrapper's
    launch plan, which must have the same shared memory and count on no more
    blocks per SM than fit."""
    from lap_tpu_torch.ops import int8_matmul as i8

    for name, module, *_ in quant_kinds():
        kind = name[:4]
        for rows in (8, 16):
            info = module.info(rows)
            plan = i8.launch_plan(kind, rows, 2048, 2048, 256 if kind == "int4" else None)
            log(f"kernel {name} {rows} rows a tile: {info['registers']} registers, {info['local_bytes']} bytes "
                f"of local memory (spills), {info['smem']} bytes of shared memory, {info['blocks_per_sm']} "
                f"resident blocks per SM (plan: {plan['smem']} bytes, at least {plan['blocks_per_sm']} blocks)")
            if info["smem"] != plan["smem"] or info["blocks_per_sm"] < plan["blocks_per_sm"]:
                raise AssertionError(f"{name}: the launch plan disagrees with the compiled kernel: {info} {plan}")


def check_quant_kernels(device):
    """Each dequant kernel against its plain version (f32, same bf16 x) at
    every quantized weight shape of the paths and 1, 16, 100 and 128 rows;
    the same bits from two calls (the split-K sums run in a fixed order);
    and the split-K arrival counters back at zero after all the calls."""
    import torch

    from lap_tpu_torch.ops import int8_matmul as i8

    g = torch.Generator(device=device).manual_seed(6)
    worst = {}
    for shape_name, k, n in QUANT_SHAPES:
        w = (torch.randn((k, n), generator=g, device=device) * 0.02).to(torch.bfloat16)
        for name, _, quantize, kernel, plain in quant_kinds():
            wq, scale = quantize(w)
            for m in QUANT_ROWS:
                x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
                got = kernel(x, wq, scale)
                torch.cuda.synchronize()
                ref = plain(x.float(), wq, scale)
                err = (got.float() - ref).abs()
                bound = QUANT_RTOL * ref.abs() + QUANT_ATOL_OF_MAX * ref.abs().max()
                log(f"kernel {name} case={shape_name} M={m} K={k} N={n} max_abs_err={err.max().item():.3e} "
                    f"max|ref|={ref.abs().max().item():.3e} worst err/bound={(err / bound).max().item():.3f}")
                if got.dtype != torch.bfloat16 or not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name} {shape_name} M={m}: bad output")
                if bool((err > bound).any()):
                    raise AssertionError(f"{name} {shape_name} M={m}: differs beyond {QUANT_RTOL}|ref| + "
                                         f"{QUANT_ATOL_OF_MAX} max|ref|")
                if not torch.equal(got, kernel(x, wq, scale)):
                    raise AssertionError(f"{name} {shape_name} M={m}: two calls gave different bits")
                worst[name] = max(worst.get(name, 0.0), err.max().item())
            del wq, scale
        del w
    if int(i8.splitk_counters(device).abs().sum()) != 0:
        raise AssertionError("the split-K arrival counters are not back at zero")
    log("kernel dequant: the split-K arrival counters are back at zero after every call")
    torch.cuda.empty_cache()
    return worst


def profile_cuda(run, what: str):
    """Run ``run()`` under the profiler, with ``PROFILE_PAD_S`` of idle time
    on either side, until the trace holds device events, at most
    ``PROFILE_ATTEMPTS`` times. Returns (the CUDA kernels of
    ``key_averages()``, the host's ms for ``run()`` with a final sync);
    raises if every attempt held none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        if events:
            return events, wall_ms
        log(f"profile: the trace of {what} holds no device event (attempt {attempt} of {PROFILE_ATTEMPTS})")
    raise AssertionError(f"the profiler recorded no device time for {what} in {PROFILE_ATTEMPTS} attempts")


def device_ms_per_call(fns, iters: int) -> float:
    """Device time per call, summed over every kernel a call launches
    (torch.profiler), cycling through ``fns``. A dequant call takes the host
    longer to launch than the card to run, so an event-timed loop would time
    the host. Each kernel counts with its mean time per launch times its
    launches per call: the trace may drop a few events at its ends (one call
    once gave a time below the bound from the sum of the recorded events)."""
    import torch

    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    events, _ = profile_cuda(run, f"{iters} timed calls")
    if any(e.count % iters for e in events):
        log(f"timing: the profile recorded {[e.count for e in events]} launches of its kernels for {iters} calls")
    return sum(e.device_time_total / e.count * max(1, round(e.count / iters)) for e in events) / 1e3


def dequant_bound(name, m, k, n):
    """Least time for one call: its bytes (x, the packed weight and scales
    read once, out written once) at 3.35 TB/s, or its 2MKN bf16 operations
    at 989 TFLOP/s, whichever is larger."""
    weight = k * n + n * 4 if name == "int8_matmul" else k * n // 2 + (k // 256) * n * 4
    nbytes = m * k * 2 + weight + m * n * 2
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = 2 * m * k * n / PEAK_BF16_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("operations" if flops_ms > bytes_ms else "bytes"), nbytes


def time_quant_kernels(device):
    """Each dequant kernel at every ``QUANT_TIMED`` shape and row count, with
    cold L2, beside its bound, its plain version and ``torch.matmul`` on the
    bf16 weight (what the bf16 path runs, 2x or 4x the weight bytes);
    ``torch._weight_int8pack_mm`` too where it runs on CUDA. Returns
    {kernel: {(shape, M): timing}}."""
    import itertools

    import torch

    from lap_tpu_torch.ops import int8_matmul as i8

    g = torch.Generator(device=device).manual_seed(7)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {name: (k, n) for name, k, n in QUANT_SHAPES}
    out = {name: {} for name, *_ in quant_kinds()}
    rows_of = {}
    for shape_name, m in QUANT_TIMED:
        rows_of.setdefault(shape_name, []).append(m)
    for shape_name, rows in rows_of.items():
        k, n = shapes[shape_name]
        w = (torch.randn((k, n), generator=g, device=device) * 0.02).to(torch.bfloat16)
        lib_copies = [w] + [w.clone() for _ in range(max(0, math.ceil(COLD_BYTES / w.nbytes) - 1))]
        for name, _, quantize, kernel, plain in quant_kinds():
            wq, scale = quantize(w)
            copies = [(wq, scale)] + [(wq.clone(), scale.clone())
                                      for _ in range(max(0, math.ceil(COLD_BYTES / wq.nbytes) - 1))]
            for m in rows:
                x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
                ms = device_ms_per_call([lambda c=c: kernel(x, *c) for c in copies], iters=40)
                cycle = itertools.cycle(copies)
                events_ms = time_cuda(lambda: kernel(x, *next(cycle)), iters=40)
                plain_ms = device_ms_per_call([lambda: plain(x, wq, scale)], iters=3)
                library_ms = device_ms_per_call([lambda c=c: torch.matmul(x, c) for c in lib_copies], iters=40)
                bound_ms, bound_by, nbytes = dequant_bound(name, m, k, n)
                pack_ms = None
                if name == "int8_matmul":
                    try:
                        w_nk, s_bf16 = wq.t().contiguous(), scale.to(torch.bfloat16)
                        pack_ms = device_ms_per_call([lambda: torch._weight_int8pack_mm(x, w_nk, s_bf16)], iters=20)
                        del w_nk
                    except (RuntimeError, NotImplementedError) as e:  # a yardstick only, never on the path
                        log(f"timing {name} {shape_name} M={m}: torch._weight_int8pack_mm does not run here "
                            f"({type(e).__name__}: {str(e).splitlines()[0][:120]})")
                out[name][(shape_name, m)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                )
                plan = i8.launch_plan(name[:4], m, k, n, 256 if name == "int4_matmul" else None, sms)
                one_row = out[name].get((shape_name, 1))
                log(f"timing {name} {shape_name} M={m} K={k} N={n} grid={plan['grid']} "
                    f"(row tiles, column blocks, splits; {plan['chunks_per_split']} chunks a split, "
                    f"{plan['in_flight_per_sm'] / 1024:.1f} KB of weight in flight per SM): kernel_ms={ms:.5f} "
                    + ("" if one_row is None or m == 1 else f"({ms / one_row['ms']:.3f}x its 1-row time) ")
                    + f"(device time, "
                    f"{len(copies)} weight copies; event-timed loop {events_ms:.5f}) bound_ms={bound_ms:.5f} "
                    f"({bound_by}, {nbytes} bytes) x{ms / bound_ms:.2f} of bound, "
                    f"{nbytes / ms / 1e6:.1f} GB/s; plain_ms={plain_ms:.5f} "
                    f"library_ms(torch.matmul, bf16 weight)={library_ms:.5f}"
                    + ("" if pack_ms is None else f" torch._weight_int8pack_mm_ms={pack_ms:.5f}"))
            del wq, scale, copies
        del w, lib_copies
    torch.cuda.empty_cache()
    return out


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


# Names of the dequant kernels in a profile: one kernel per call.
DEQUANT_KERNEL_NAMES = ("int8_matmul", "int4_matmul")
# Kernel families of a profile, by substrings of the kernel's name; the first
# family that matches takes the kernel, "other" the rest.
KERNEL_FAMILIES = (
    ("flash kernels", ("flash_",)),
    ("dequant kernels", DEQUANT_KERNEL_NAMES),
    ("foreach passes (optimizer, EMA, norms)", ("multi_tensor_apply",)),
    ("convolution", ("cudnn", "convolve", "fprop", "wgrad", "dgrad")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("copies and casts", ("Memcpy", "Memset", "copy", "CatArray")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def report_profile(events, what: str, wall_ms: float, tokens: int = 0) -> int:
    """Device time of one profiled call (its CUDA kernels from
    ``profile_cuda``) against its wall time: the largest kernels by name,
    then every kernel summed by family, so that the families add up to the
    whole device time (and per token, for an AR request). Returns the
    launches of dequant kernels in the profile."""
    device_ms = sum(e.device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    log(f"profile: one {what} wall_ms={wall_ms:.3f} device_kernel_ms={device_ms:.3f} kernels={n_kernels}"
        + (f" per token: wall_ms={wall_ms / tokens:.3f} device_ms={device_ms / tokens:.3f} "
           f"kernels={n_kernels / tokens:.1f}" if tokens else ""))
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
        if any(k in e.key for k in ("flash_", *DEQUANT_KERNEL_NAMES)):
            log(f"profile:   kernel {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    return sum(e.count for e in events if any(k in e.key for k in DEQUANT_KERNEL_NAMES))


def profile_one_request(policy, request, what: str = "infer", tokens: int = 0) -> int:
    events, wall_ms = profile_cuda(lambda: policy.infer(request), what)
    return report_profile(events, what, wall_ms, tokens)


def reset_launch_counters() -> None:
    from lap_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0
    fa.launches_bwd_delta = fa.launches_bwd_group_sum = 0
    for _, module, *_ in quant_kinds():
        module.launches = 0


def serving_launches() -> tuple[int, int, int]:
    """(flash forward, int8, int4) launches since the last reset."""
    from lap_tpu_torch.ops import flash_attention as fa

    return (fa.launches, *(module.launches for _, module, *_ in quant_kinds()))


def percentiles(latencies):
    lat = sorted(latencies)
    return statistics.median(lat), lat[min(len(lat) - 1, math.ceil(0.9 * len(lat)) - 1)]


def build_serving_model(device):
    import torch

    from lap_tpu_torch.models.lap_model import LAP, LAPConfig

    config = LAPConfig(
        action_dim=7, action_horizon=16, max_token_len=PROMPT_LEN, enable_action_training=True
    )
    t0 = time.monotonic()
    model = LAP(config, device=device, init_seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"policy: built LAP-3B ({n_params} params, bf16) in {time.monotonic() - t0:.1f} s")
    return model, config


def run_policy(model, config, device):
    import numpy as np
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import Policy, _stack_batch

    policy = Policy(model, num_steps=10, seed=0)
    requests = [make_request(i, config) for i in range(N_REQUESTS)]
    warm = policy.infer(requests[0])  # first call: cuBLAS/cuDNN setup
    log(f"policy: warm-up infer {warm['policy_timing']['infer_ms']:.1f} ms")

    reset_launch_counters()
    latencies, per_request = [], []
    for req in requests:
        before = serving_launches()
        out = policy.infer(req)
        per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
        latencies.append(out["policy_timing"]["infer_ms"])
        actions = out["actions"]
        if actions.shape != (16, 7) or not np.isfinite(actions).all():
            raise AssertionError(f"bad actions: shape {actions.shape}")
    launches = serving_launches()[0]
    depth = len(model.llm.layers)
    log(f"policy: (flash, int8, int4) launches per request {sorted(set(per_request))} (flash total {launches})")
    if any(c != (depth, 0, 0) for c in per_request):
        raise AssertionError(f"expected {depth} flash and no dequant launches per request, got {per_request}")

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

    p50, p90 = percentiles(latencies)
    log(
        f"policy: infer over {len(latencies)} requests p50_ms={p50:.3f} p90_ms={p90:.3f} "
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


def run_quant_flow(model, config, device):
    """Flow requests with int8, then int4 copies of the decode weights: only
    the action expert's MLPs (16 rows per Euler step) take the dequant
    kernels; the 692-row prefill keeps the exact bf16 product. Returns
    {mode: (flash, int8, int4) launches}."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import Policy, _stack_batch

    depth = len(model.llm.layers)
    requests = [make_request(200 + i, config) for i in range(QUANT_FLOW_REQUESTS)]
    obs = CoTObservation.from_dict(_stack_batch([requests[0]]), device=device)
    noise = torch.randn((1, config.action_horizon, config.action_dim),
                        generator=torch.Generator(device=device).manual_seed(8), device=device)
    model.quantize_(None)
    exact = model.sample_actions(obs, noise=noise)
    totals = {}
    for mode in ("int8", "int4"):
        model.quantize_(mode)
        policy = Policy(model, num_steps=10, seed=0)
        policy.infer(requests[0])  # first use of the kernels at these shapes
        expected = (depth, 2 * depth * 10 if mode == "int8" else 0, 2 * depth * 10 if mode == "int4" else 0)
        reset_launch_counters()
        latencies, per_request = [], []
        for req in requests:
            before = serving_launches()
            out = policy.infer(req)
            per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            latencies.append(out["policy_timing"]["infer_ms"])
            if out["actions"].shape != (16, 7) or not np.isfinite(out["actions"]).all():
                raise AssertionError(f"{mode} flow: bad actions")
        totals[mode] = serving_launches()
        if any(c != expected for c in per_request):
            raise AssertionError(f"{mode} flow: expected {expected} (flash, int8, int4) launches, got {per_request}")
        got = model.sample_actions(obs, noise=noise)
        rel = ((got - exact).norm() / exact.norm()).item()
        p50, p90 = percentiles(latencies)
        log(f"quant flow {mode}: (flash, int8, int4) launches per request {expected} over {len(requests)} "
            f"requests; infer p50_ms={p50:.3f} p90_ms={p90:.3f} all_ms={[round(x, 3) for x in latencies]}; "
            f"actions vs bf16 rel_err={rel:.3e} (information)")
    model.quantize_(None)
    return totals


def run_ar(model, config, device):
    """AR serving through ``ARPolicy`` at batch 1, ``AR_STEPS`` tokens per
    request, in bf16, int8 and int4, with exact launch counts per request.
    Returns {mode: (flash, int8, int4) launches}."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import ARPolicy, _stack_batch

    depth = len(model.llm.layers)
    per_quant = (4 * depth + 1) * AR_STEPS + 1
    vocab = model.llm.embedder.input_embedding.shape[0]
    requests = [make_request(300 + i, config) for i in range(AR_REQUESTS)]
    obs = CoTObservation.from_dict(_stack_batch([requests[0]]), device=device)
    totals = {}
    for mode in ("bf16", "int8", "int4"):
        model.quantize_(None if mode == "bf16" else mode)
        policy = ARPolicy(model, max_decoding_steps=AR_STEPS, stop_on_eos=False, seed=0)
        policy.infer(requests[0])  # first use of the kernels at these shapes
        expected = (depth, per_quant if mode == "int8" else 0, per_quant if mode == "int4" else 0)
        reset_launch_counters()
        latencies, per_request = [], []
        for req in requests:
            before = serving_launches()
            out = policy.infer(req)
            per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            latencies.append(out["policy_timing"]["infer_ms"])
            tokens = out["tokens"]
            if tokens.shape != (1, AR_STEPS) or tokens.dtype != np.int32 or not (
                    (tokens >= 0) & (tokens < vocab)).all():
                raise AssertionError(f"{mode} AR: bad tokens {tokens.shape} {tokens.dtype}")
        totals[mode] = serving_launches()
        if any(c != expected for c in per_request):
            raise AssertionError(f"{mode} AR: expected {expected} (flash, int8, int4) launches, got {per_request}")
        prefill = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.ar_prefill(obs, AR_STEPS)
            torch.cuda.synchronize()
            prefill.append((time.monotonic() - t0) * 1e3)
        p50, p90 = percentiles(latencies)
        prefill_ms = statistics.median(prefill)
        log(f"AR {mode}: {AR_STEPS} tokens per request at batch 1, (flash, int8, int4) launches per request "
            f"{expected} over {len(requests)} requests; infer p50_ms={p50:.3f} p90_ms={p90:.3f} "
            f"ms_per_token(p50/{AR_STEPS})={p50 / AR_STEPS:.3f} prefill_ms={prefill_ms:.3f} "
            f"decode_ms_per_token={(p50 - prefill_ms) / AR_STEPS:.3f} "
            f"all_ms={[round(x, 3) for x in latencies]} tokens[0][:8]={tokens[0, :8].tolist()}")
        profiled = profile_one_request(policy, requests[0], what=f"AR request ({mode}, {AR_STEPS} tokens)",
                                       tokens=AR_STEPS)
        # One kernel per dequant call: the profile holds as many dequant kernels
        # as the counters count calls, less the few events a trace of ~100k
        # kernels may drop at its ends (every family loses them alike); a
        # second kernel per call would double the count.
        calls = sum(expected[1:])
        log(f"profile: AR {mode} dequant kernels in the profile {profiled} for {calls} dequant calls")
        if not PROFILE_KEPT_SHARE * calls <= profiled <= calls:
            raise AssertionError(f"{mode} AR: the profile holds {profiled} dequant kernels for {calls} dequant calls")
    model.quantize_(None)
    return totals


def ar_logits(model, obs, forced=None):
    """Logits of the prefill and of ``AR_FORCED_STEPS`` steps [1, S + 1, V]
    (f32) and the tokens fed: greedy, or ``forced``."""
    import torch

    state = model.ar_prefill(obs, AR_FORCED_STEPS)
    logits, tokens = [state.logits.float()], []
    for i in range(AR_FORCED_STEPS):
        token = state.logits.argmax(dim=-1).to(torch.int32) if forced is None else forced[:, i : i + 1]
        tokens.append(token)
        logits.append(model.ar_step(state, token).float())
    return torch.cat(tokens, dim=1), torch.cat(logits, dim=1)


def plain_in_float64(name):
    """The plain version of a dequant matmul with its sum taken in float64:
    another correct rounding of the same function, to show how far the AR
    path moves on rounding alone."""
    import torch

    from lap_tpu_torch.ops.int4_matmul import unpack_nibbles

    def int8(x, w, scale):
        return ((x.double() @ w.double()) * scale.double()).to(x.dtype)

    def int4(x, packed, scale):
        lo, hi = unpack_nibbles(packed)
        group = 2 * packed.shape[0] // scale.shape[0]
        w = torch.cat([lo, hi]).double() * torch.repeat_interleave(scale.double(), group, dim=0)
        return (x.double() @ w).to(x.dtype)

    return int8 if name == "int8_matmul" else int4


def check_ar_kernels_against_plain(model, config, device):
    """Quantized AR decode with the dequant kernels against the same model
    with the plain versions in their place, fed the same tokens, beside the
    plain versions against themselves with float64 sums (the path's rounding
    floor); every dequant call of the kernel pass against the plain version
    on the same input; and the first logits against the bf16 model's
    (information: the weight rounding)."""
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import _stack_batch

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    obs = CoTObservation.from_dict(_stack_batch([make_request(400, config)]), device=device)
    model.quantize_(None)
    _, exact = ar_logits(model, obs)
    failures = []
    for name, module, _, kernel, plain in quant_kinds():
        mode = name.split("_")[0]
        model.quantize_(mode)
        calls = []

        def checked(x, w, scale, kernel=kernel, plain=plain, calls=calls):
            got = kernel(x, w, scale)
            ref = plain(x.float(), w, scale)
            bound = QUANT_RTOL * ref.abs() + QUANT_ATOL_OF_MAX * ref.abs().max()
            calls.append(((got.float() - ref).abs() / bound).max().item())
            return got

        reset_launch_counters()
        runs = {}
        for label, fn in (("kernel", checked), ("plain", plain), ("plain_f64", plain_in_float64(name))):
            setattr(module, name, fn)  # the model's calls find this version in the kernel's place
            try:
                tokens, runs[label] = ar_logits(model, obs, forced=runs.get("tokens"))
                runs.setdefault("tokens", tokens)
            finally:
                setattr(module, name, kernel)
            if label == "kernel":
                launched = module.launches
        if launched != len(calls) or launched == 0 or module.launches != launched:
            raise AssertionError(f"{mode}: {launched} kernel launches for {len(calls)} checked calls, "
                                 f"{module.launches - launched} in the plain passes")
        steps = runs["kernel"].shape[1]
        err, floor = rel(runs["kernel"], runs["plain"]), rel(runs["plain"], runs["plain_f64"])
        log(f"path: AR {mode} logits with kernels vs plain versions, teacher-forced over {AR_FORCED_STEPS} steps: "
            f"rel_l2={err:.3e} per step {[round(rel(runs['kernel'][:, i], runs['plain'][:, i]), 5) for i in range(steps)]}; "
            f"floor (plain, f32 vs f64 sums) rel_l2={floor:.3e} per step "
            f"{[round(rel(runs['plain'][:, i], runs['plain_f64'][:, i]), 5) for i in range(steps)]}; "
            f"pass if <= {AR_FLOOR_FACTOR} x floor (target {AR_KERNEL_REL_TOL}: "
            f"{'met' if err <= AR_KERNEL_REL_TOL else 'not met'}); {len(calls)} dequant calls each against the "
            f"plain version on its input, worst err/bound={max(calls):.3f}; first logits {mode} vs bf16 "
            f"rel_l2={rel(runs['kernel'][:, 0], exact[:, 0]):.3e} (information)")
        if not (torch.isfinite(runs["kernel"]).all() and err <= AR_FLOOR_FACTOR * floor and max(calls) <= 1.0):
            failures.append(mode)
    model.quantize_(None)
    if failures:
        raise AssertionError(f"AR logits with the kernels differ from the plain versions beyond the floor: {failures}")


def check_small_ar_reference(device) -> None:
    """The dummy-size model's AR decode in f32 on the card against the same
    weights on the CPU (the path the CPU tests hold against the JAX package)."""
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
    with torch.no_grad():
        cpu.llm.embedder.input_embedding.mul_(100.0)
    gpu = LAP(config, device=device, init_seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(9)
    batch = {
        "image": {k: rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8) for k in config.image_keys},
        "state": rng.standard_normal((2, 7)).astype(np.float32),
        "tokenized_prompt": rng.integers(0, 257_152, (2, 16)).astype(np.int32),
        "tokenized_prompt_mask": np.arange(16)[None, :] < np.array([[12], [5]]),
    }
    kw = dict(max_decoding_steps=SMALL_AR_STEPS, stop_on_eos=False)
    ref = cpu.sample_tokens(CoTObservation.from_dict(batch, device="cpu"), **kw)
    got = gpu.sample_tokens(CoTObservation.from_dict(batch, device=device), **kw).cpu()
    ref_logits = cpu.ar_prefill(CoTObservation.from_dict(batch, device="cpu"), 1).logits
    got_logits = gpu.ar_prefill(CoTObservation.from_dict(batch, device=device), 1).logits.cpu()
    err = ((got_logits - ref_logits).abs().max() / ref_logits.abs().max()).item()
    log(f"small reference: dummy LAP f32 AR decode card vs CPU tokens equal={torch.equal(got, ref)} "
        f"first logits max_abs_err/max={err:.3e} (tol {SMALL_REF_TOL}); tokens {got.tolist()}")
    if not (torch.equal(got, ref) and err <= SMALL_REF_TOL):
        raise AssertionError("card and CPU disagree on the dummy model's AR decode")


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
    events, wall_ms = profile_cuda(lambda: trainer.run(batch, 1), "training step")
    report_profile(events, "training step", wall_ms)


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

    def counts():
        return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_delta,
                fa.launches_bwd_group_sum)

    reset_launch_counters()
    torch.cuda.reset_peak_memory_stats()
    records, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = counts()
        records += trainer.run(batch, 1)
        per_step.append(tuple(a - b for a, b in zip(counts(), before)))
    launches = dict(zip(("fwd", "dq", "dkv", "delta", "group_sum"), counts()))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"training: launches per step (fwd, dq, dkv, delta, group_sum) {per_step} (totals {launches})")
    depth = len(trainer.model.llm.layers)
    attn = trainer.model.llm.layers[0].attn
    grouped = attn.configs[0].num_heads > attn.configs[0].num_kv_heads
    expected = (2 * depth, depth, depth, depth, depth if grouped else 0)
    if any(c != expected for c in per_step):
        raise AssertionError(f"expected {expected} launches per step, got {per_step}")
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
    from lap_tpu_torch.ops import int4_matmul as i4
    from lap_tpu_torch.ops import int8_matmul as i8

    t0 = time.monotonic()
    sources = (fa.SOURCE, fa.BWD_SOURCE, i8.SOURCE, i4.SOURCE)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # nvcc runs as a subprocess
        list(pool.map(cuda_build.build, sources))
    log(f"build: {', '.join(sources)} in {time.monotonic() - t0:.1f} s (one nvcc each, in parallel)")
    for source in sources:
        for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build: {source}: {line.strip()}")

    occupancy = backward_occupancy(TRAIN_BATCH)
    fwd_occupancy = forward_occupancy(device)
    max_err = check_flash_kernel(device)
    bwd_err = check_flash_backward(device)
    timing = time_flash_kernel(device)
    dequant_kernel_info()
    quant_err = check_quant_kernels(device)
    quant_timing = time_quant_kernels(device)
    check_small_reference(device)
    check_small_ar_reference(device)
    check_small_train_reference(device)

    model, config = build_serving_model(device)
    flow_launches = run_policy(model, config, device)
    quant_flow = run_quant_flow(model, config, device)
    ar = run_ar(model, config, device)
    check_ar_kernels_against_plain(model, config, device)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = run_training(device)
    torch.cuda.empty_cache()
    bwd_timing = time_flash_backward(device, TRAIN_BATCH)

    csrc = "lap_tpu_torch/csrc/"
    kernels = [
        dict(
            name="flash_attention_fwd", route="cuda", source=csrc + fa.SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:53",
            launches=flow_launches + sum(c[0] for c in quant_flow.values()) + sum(c[0] for c in ar.values())
            + train_launches["fwd"],
            launches_flow=flow_launches, launches_quant_flow=sum(c[0] for c in quant_flow.values()),
            launches_ar=sum(c[0] for c in ar.values()), launches_training=train_launches["fwd"],
            max_abs_err=max(max_err, bwd_err["fwd"]), **timing,
            timed_at=f"B=1 T=S={LAP_PREFIX} (serving prefill)",
            training_shape={k: v for k, v in bwd_timing["fwd"].items() if k != "batch"},
            occupancy=fwd_occupancy,
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
        dict(
            name="flash_attention_bwd_delta", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:270", launches=train_launches["delta"],
            max_abs_err=bwd_err["delta"], **bwd_timing["delta"],
        ),
        dict(
            name="flash_attention_bwd_group_sum", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:340", launches=train_launches["group_sum"],
            max_abs_err=bwd_err["group_sum"], **bwd_timing["group_sum"],
        ),
    ]
    for name in ("dq", "dkv"):
        kernels[1 + (name == "dkv")].update({f"occupancy_{k}": v for k, v in occupancy[name].items()})
    json_shape, json_rows = QUANT_JSON_SHAPE
    k, n = {name: (k, n) for name, k, n in QUANT_SHAPES}[json_shape]
    for index, (name, replaces) in enumerate((("int8_matmul", "lap_tpu/ops/int8_matmul.py:56"),
                                              ("int4_matmul", "lap_tpu/ops/int4_matmul.py:93"))):
        kernels.append(dict(
            name=name, route="cuda", source=csrc + (i8.SOURCE, i4.SOURCE)[index], replaces=replaces,
            launches=quant_flow[name[:4]][1 + index] + ar[name[:4]][1 + index],
            launches_quant_flow=quant_flow[name[:4]][1 + index], launches_ar=ar[name[:4]][1 + index],
            max_abs_err=quant_err[name], timed_at=f"M={json_rows} K={k} N={n} ({json_shape})",
            **quant_timing[name][QUANT_JSON_SHAPE],
        ))
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
