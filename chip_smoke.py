#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
 1. build every CUDA kernel of the path from the sources in this checkout
    (``lap_tpu_torch/csrc/``, into ``lap_tpu_torch/_build/``);
 2. hold each kernel against its plain PyTorch version on the card, on the
    main path's shapes and edge cases, with the tolerances stated below;
 3. time each kernel, its plain version and one PyTorch library call that
    computes the same function (a yardstick the port never calls), beside the
    least time the card could take (``bound_ms``);
 4. run the dummy-size model in f32 on the card and on the CPU with the same
    weights (the CPU path is what the tests hold against the JAX package);
 5. build the full-width LAP-3B flow policy (gemma_2b + gemma_300m + SigLIP
    So400m/14, bf16) on the card from seeded random weights;
 6. serve requests through ``Policy.infer`` with the launch counters reset
    just before and read just after: 18 flash launches per request;
 7. compare ``sample_actions`` with ``attn_impl="flash"`` against
    ``attn_impl="xla"`` on one request with the same noise;
 8. report infer latency (p50, p90 over ``N_REQUESTS`` closed-loop requests
    at batch 1) and the chunk rate, and profile one more request: device
    time by kernel against its wall time.

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
# Whole path, flash vs einsum attention: the einsum path rounds P to bf16
# and the prefix K/V cache differs in the last bf16 bit; the difference
# passes through 18 random-weight layers and 10 Euler steps (measured
# 1.4e-3 on an H100; 7x margin).
PATH_REL_TOL = 1e-2
# The dummy-size model in f32 on the card against the same weights on the
# CPU: f32 sums in another order (TF32 off).
SMALL_REF_TOL = 1e-4

# Closed loop, one client, batch 1: enough requests that p90 has ten beyond it.
N_REQUESTS = 100
LAP_PREFIX = 2 * 256 + 180  # two 224^2 cameras at patch 14, plus the prompt
PROMPT_LEN, PROMPT_VALID = 180, 40


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
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
        err = (out.float() - ref_out.float()).abs()
        bound = OUT_ATOL + OUT_RTOL * ref_out.float().abs()
        lse_err = (lse - ref_lse).abs().max().item()
        dead = ~mask.any(dim=-1)  # [B, T]
        log(
            f"kernel flash_attention_fwd case={name} shape=B{b} T{t} S{s} N{n} K{kh} H{h} "
            f"out_max_abs_err={err.max().item():.3e} lse_max_abs_err={lse_err:.3e} "
            f"dead_rows={int(dead.sum())}"
        )
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if bool((err > bound).any()):
            raise AssertionError(f"{name}: out differs beyond atol {OUT_ATOL} + rtol {OUT_RTOL}")
        if lse_err > LSE_ATOL:
            raise AssertionError(f"{name}: lse differs by {lse_err} > {LSE_ATOL}")
        if dead.any():
            dead_out = out.float()[dead]
            if dead_out.abs().max().item() != 0.0:
                raise AssertionError(f"{name}: fully masked rows are not zero")
        worst = max(worst, err.max().item())
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


def profile_one_request(policy, request) -> None:
    """Device time by kernel over one infer, against its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        policy.infer(request)
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    log(f"profile: one infer wall_ms={wall_ms:.3f} device_kernel_ms={device_ms:.3f} "
        f"kernels={sum(e.count for e in events)}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        log(f"profile:   {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


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
    cuda_build.build(fa.SOURCE)
    log(f"build: {fa.SOURCE} in {time.monotonic() - t0:.1f} s")
    for line in cuda_build.BUILD_LOGS.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"build: {line.strip()}")

    max_err = check_flash_kernel(device)
    timing = time_flash_kernel(device)
    check_small_reference(device)
    launches = run_policy(device)

    kernels = [
        dict(
            name="flash_attention_fwd",
            route="cuda",
            source="lap_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="lap_tpu/ops/flash_attention.py:53",
            launches=launches,
            max_abs_err=max_err,
            kernel_ms=timing["ms"],
            **timing,
        )
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
