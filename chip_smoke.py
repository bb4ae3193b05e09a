#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Eight paths are driven: LAP-3B flow-matching serving in bf16 (phase 6) and
with int8/int4 expert MLPs (phase 7), LAP-3B AR language-action serving in
bf16, int8 and int4 (phase 8), the serving stack from raw robot requests and
a checkpoint directory (phase 9), the LAP-3B training step (phases 11-12),
the training entry points with their checkpoints, resume, validation,
offline eval and serving of the trained step (phase 13), the Gemma3
family: LAPGemma3-4B flow, AR and quantized serving, its serving stack and
its training step (phase 14), and the rest of the model surface: FAST
action tokens, the pi0 branch, the VLM-only model and LoRA training
(phase 15), training ``lap_libero`` from RLDS episodes through the data
pipeline (phase 16), and parallelism past one card (phase 17: tensor-parallel
serving, FSDP and tensor + sequence parallel training through ``train.main``).
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
    decode slots), at batch 2 on the prefill of two robots' prompts of 78
    and 108 valid tokens (the batched serving call), at 640 rows on the
    prefill trimmed by the token bucket (92 valid prompt tokens in 128
    slots), and two forward calls at the prefills and the training call must
    give the same bits; the training call
    is held at the path's batch and with the strides the model gives it (q
    and the mask are the first 692 rows of the joint 708-row tensors),
    forward (out, lse) and backward, and two backward calls there and at GQA
    group 4 must give the same bits; the dequant matmuls at 1, 16, 100 and
    128 rows for every quantized weight shape, two calls giving the same
    bits at each, and their split-K arrival counters back at zero after all
    the calls; print the forward's and the backward kernels' registers,
    spills, resident blocks per SM and waves beside their plans, and the
    dequant kernels' beside their launch plan; the LAPGemma3-4B cases of
    phase 14: the forward (and backward) at the flow and AR prefills' local-
    and global-layer masks (B=1, T=800, S=800/864, GQA group 2, K=4; the AR
    local mask with valid rows that see no key), the training call (B=8,
    T=S=816, its local mask, the group sum at group 2, the same bits twice),
    the dequant matmuls at gemma3_4b's weights, its 262,144-row vocab head
    and the expert's gating at K=768 (int4 group 128);
 3. time each kernel, its plain version and one PyTorch library call that
    computes the same function (a yardstick the port never calls), beside the
    least time the card could take (``bound_ms``); the dequant matmuls (every
    quantized shape at the rows its path gives it, the three largest at 16
    rows too, and MLP gate/up at 100 and 128 rows), the delta kernel and the
    group-sum pass by their device time, the flash forward at the serving
    prefill by CUDA events around a loop of calls (``ms``; at batch 1 that
    is the host's time to launch a call) and by its device time
    (``device_ms``), and the flash kernels last (the delta kernel beside
    ``torch.bmm`` with ``out_dtype=float32``, held to the delta check's bound), at the batch the training
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
    token, the prefill alone, and one profiled 16-token request per mode (an
    ``ar_profile`` JSON line), which must hold one dequant kernel per dequant
    call;
 9. the serving stack: write the serving model to a checkpoint directory
    (``checkpoints.save_params``, bf16, ~6.7 GB, with seeded norm stats),
    restore it through ``serve_policy.create_policy`` (``--env LAP``), and
    serve raw robot requests (two 224^2 uint8 cameras, a state vector and an
    instruction; one without a prompt, one without a wrist camera) through
    the transforms, the tokenizer, the model and ``Unnormalize``: actions of
    (16, 7) in physical units and 18 flash launches each; the restored
    model's actions bit-equal to the in-memory model's at the same noise;
    p50/p90 latency and the input and output stacks' host time; then AR with
    int8 copies through ``create_trained_policy_ar`` ((4*18+1)*n+1 dequant
    launches for the n tokens decoded, 18 flash), two robots at once behind
    ``BatchingPolicy`` (one call, 18 flash launches; each batched row against
    the row alone), and ``--token_bucket 64`` behind ``PolicyRecorder``
    (against the untrimmed request; the recorded ``.npz`` unflattens to the
    request); the masks the batched and the bucketed calls give the flash
    kernel must be those of the phase-2 cases at their shapes; the restore
    is timed after the params file is dropped from the host's page cache
    (with the share of its pages still there), and again; a
    ``serving_stack`` JSON line;
10. quantized AR logits with the kernels against the same model with the
    plain versions, teacher-forced, and the quantized-vs-bf16 difference of
    the first logits (information);
11. build the full-width LAP-3B trainer (the ``lap`` config: float32
    parameters under bf16 activations, AdamW, EMA, stop-gradient, per-layer
    rematerialisation) from seeded random weights and take optimizer steps on
    the synthetic batch: per step 36 forward (18 layers, run again by the
    rematerialisation), 18 delta, 18 dQ, 18 dK/dV and, with GQA groups, 18
    group-sum launches; the loss is finite and falls; step time, peak
    memory, and one profiled step with its device time summed by kernel
    family over every kernel;
12. compare one loss-and-gradient pass with the kernels against one with
    ``attn_impl="xla"`` from the same weights, batch, noise and time, and the
    float32 global gradient norm against a float64 sum over the same
    gradients;
13. the training entry points at full width with both experts cut to
    ``TRAIN_PHASE_DEPTH`` layers (``lap`` with ``--data.repo_id fake``,
    batch 8, bfloat16 parameters, the VLM frozen: see ``TRAIN_PHASE_DTYPE``
    for why), in a run directory inside the
    checkout that is deleted at the end: ``train.main`` run 1 takes 2 steps
    and saves (a step launches 2 forward and 1 of each backward kernel a
    layer);
    the loss of the next batch on its state in memory; run 2 resumes and
    takes no step (every state tensor's checksum and the loader cursor equal
    run 1's); run 3 resumes, takes one step (its loss equal to that loss, bit
    for bit) and one validation step (18 forward launches, no backward), and
    saves; ``eval.main`` over the last step (finite ``val_loss`` and
    ``action_prediction_l2``, 18 + 18 forward launches); that step directory
    served by ``create_trained_policy`` in bf16 and int8 (18 flash, and 360
    dequant launches in int8); the bytes, seconds and free disk of the saves
    and restores, the seconds the asynchronous save blocked the loop and the
    run's wait for the write (a ``train_entry_points`` JSON line);
14. the Gemma3 family (``lap_gemma3_4b``: gemma3_4b VLM, gemma3_300m expert
    with adaRMS, SigLIP So400m/14 with Gemma3's soft-embedding norm and
    bias-free head, 4.82 B parameters, bf16, seeded random weights): the
    dummy LAPGemma3 in f32 on the card against the CPU (actions within
    1e-4, AR tokens equal); ``N_REQUESTS`` flow requests through
    ``Policy.infer`` (34 flash launches each, the flash masks those of the
    phase-2 gemma3 cases), flash against einsum actions (the flow prompt
    has no valid row without a key), one profiled request; int8 and int4
    flow (340 dequant launches a request: the expert's gating); 64-token AR
    requests in bf16, int8 and int4 (34 flash launches for the right-aligned
    prefill, whose local layers have 15 valid rows with no key; 171 dequant
    launches a token quantized), a profiled 16-token request each; the
    teacher-forced quantized logits against the plain versions as in phase
    10; the serving stack (the model written to a checkpoint directory,
    restored by ``serve_policy.create_policy --config lap_gemma3_4b``, a raw
    request through ``Gemma3Tokenizer`` with the test vocabulary, its
    actions bit-equal to the in-memory model's); the training step at full
    width and ``G3_TRAIN_DEPTH`` layers (f32 parameters, AdamW, EMA, batch
    8: 12 forward and 6 of each backward launch a step, the loss at fixed
    noise and time falls, peak memory, one profiled step); the flash
    forward at the prefills and the backward at the training shape timed;
    a ``gemma3`` JSON line;
15. the rest of the model surface at full width, from one seeded LAP-3B
    (``pi05_replicated``'s model: prompt 220, prefix 732), its weights
    carried to the other models where the trees agree (no checkpoint is
    written): FAST action tokens (raw requests through the config's flow
    stack, ``VARIANT_REQUESTS`` of them, 18 flash launches each, flash
    against einsum actions; one through its AR stack, ``ARPolicy`` for
    ``AR_STEPS`` tokens then ``ExtractFASTActions``: (16, 7) actions equal
    to the extraction of the greedy tokens; the host time of
    ``TokenizeFASTInputs`` and of the BPE encode, C++ against Python, with
    the native host ops' status); the pi0 branch (``pi0_replicated
    --model.pi05 False``: flow requests as for FAST, flash against einsum);
    the VLM-only model (``vla0_replicated``, one expert, prefix 902: the
    flow ``Policy`` refuses it; raw requests through the vla0 stacks,
    ``AR_STEPS`` tokens in bf16, int8 and int4 with 18 flash and
    (4*18+1)*AR_STEPS+1 dequant launches a request, the prefill, a profiled
    16-token request a mode, the teacher-forced logits with the kernels
    within ``AR_FLOOR_FACTOR`` x the rounding floor); LoRA training (``lap``
    with gemma_2b_lora + gemma_300m_lora at full width, float32 parameters,
    AdamW, EMA, batch 8 of the fake loader's first batch, LORA_TRAIN_STEPS
    steps: 36 forward and 18 of each backward launch a step, the frozen
    leaves' bits unchanged, every adapter moved, the loss at fixed noise and
    time falls, the optimizer state on the trainable leaves only, peak
    memory, one profiled step). Every mask the phase gives the flash forward is a phase-2 case
    (the FAST and pi0 flow prefixes, the right-aligned FAST and vla0 AR
    prefills, the LoRA step); the forward is timed at the new prefills; a
    ``variants`` JSON line, and ``launches_variants`` in every kernel row;
16. ``lap_libero`` trained from RLDS episodes (the data pipeline: TFRecord
    shards, the LIBERO standardization, the norm-stats pass, the shuffle
    buffers and the weighted mixture, the native JPEG decode and resize in
    the loader's threads, ``Normalize``), at full width with both experts
    cut to ``TRAIN_PHASE_DEPTH`` layers, bf16 parameters, the VLM frozen,
    batch 8: four ``libero_*_no_noops`` datasets of ``RLDS_EPISODES``
    episodes of ``RLDS_EPISODE_STEPS`` steps (256^2 primary and wrist
    frames, JPEG at quality 95 by the port's encoder, 8 state and 7 action
    values, one instruction an episode) written to a directory of the
    checkout, deleted at the end; the write's seconds and bytes, the
    norm-stats pass, the loader alone (samples/s at batch 8 on 8 threads,
    the first batch's latency, host ms a sample for decode + resize);
    ``train.main`` run 1 takes ``RLDS_TRAIN_STEPS`` steps and saves (a step
    launches 2 forward and 1 of each backward kernel a layer, as phase 13;
    every flash mask has the ``libero_training_step`` case's shape, the
    joint [8, 702, 702] call): the median step time, each
    step's wait for its batch, the peak memory, the step directory's bytes;
    run 2 resumes and takes one step, its loss equal to the loss of the
    batch the uninterrupted stream gives next on run 1's state, bit for bit;
    the same model fed by the ``fake`` repo at the same settings, for the
    step time; an ``rlds_training`` JSON line, and
    ``launches_rlds_training`` in the flash rows.
17. parallelism (``lap_tpu_torch/parallel/``), in spawned worlds of two
    ranks that share the one card over gloo (NCCL refuses two ranks on one
    device; ``PARALLEL_BACKEND``), each rank on ``cuda:0``, every rank
    stopped before the phase goes on; phase 2 holds the flash kernels at one
    rank's heads under tp = 2 (``tp2_*`` cases: LAP's prefill and training
    call at 4 query heads on 1 KV head, LAPGemma3-4B's 800-row prefill at 4
    on 2). a, inside phase 9 (its checkpoint directory):
    ``create_trained_policy(..., tp=2)`` on each rank, flow requests on rank
    0 with rank 1 in ``serve_followers``, 18 flash launches a rank and
    request, actions within ``PATH_REL_TOL`` of the one-process policy of
    the same directory and seeds; ``create_trained_policy_ar`` for
    ``TP_AR_TOKENS`` greedy tokens, equal to one process's before the
    first near tie, and the logits teacher-forced with one process's tokens
    within twice one process's flash-vs-einsum floor (at least
    ``PATH_REL_TOL``); latency printed as two ranks on one card. b:
    LAPGemma3-4B from seed 0 sharded in memory by ``copy_shards`` (what
    ``restore_params_sharded`` runs), one flow request at explicit noise
    against one process's model, 34 flash launches a rank. c: ``train.main``
    at ``lap``'s width, depth ``TRAIN_PHASE_DEPTH``, f32 parameters + AdamW
    + EMA, global batch ``PARALLEL_TRAIN_BATCH``, ``PARALLEL_TRAIN_STEPS``
    steps, in one process, on a 1-rank NCCL world, at ``--fsdp_devices 2``
    and at ``--tp_devices 2 --sequence_parallel true``: each logged loss
    and grad norm against one process's (``PARALLEL_LOSS_REL_TOL``,
    ``PARALLEL_GRAD_NORM_REL_TOL``), every leaf of the first step's
    gradient (``gradient_leaves``: ``GRAD_LEAF_REL_TOL`` of its norm plus
    ``GRAD_LEAF_FLOOR`` of the whole gradient's), peak memory a rank; these
    runs write no step directory (the disk budget); then one step under FSDP
    at phase 13's settings, saved, restored into one process: every state
    tensor bit-equal to the sharded run's whole tensor, and the next batch's
    loss over each data rank's rows bit-equal to that rank's own. b and c's
    two-rank runs share one world; each world starts while the parent runs
    the one-process references. d: ``fsdp_sharding(..., log=True)`` of
    lap_gemma3_12b and lap_gemma3_27b on the meta device at (fsdp 4) and
    (fsdp 2, tp 2). A ``parallel`` JSON line; ``launches_parallel`` in every
    flash row.

The serving models are freed before the training phases. The last lines of
standard output are the ``kernels`` JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": ...}``; whether the
native host ops (``lap_tpu_torch/native.py``) loaded is logged in phase 9. The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
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
# (name, K, N) of every quantized weight of LAP-3B serving, then of
# LAPGemma3-4B serving (phase 14): gemma3_4b's q and kv (both [2560, 2048]),
# attn_vec, gating and linear, the 262,144-row vocab head, and the
# gemma3_300m expert's gating (K = 768: int4 takes group 128 there).
QUANT_SHAPES = (
    ("q_attn_vec", 2048, 2048), ("mlp_gate_up", 2048, 32768), ("mlp_down", 16384, 2048),
    ("vocab", 2048, 257152), ("expert_gate_up", 1024, 8192), ("expert_down", 4096, 1024),
    ("g3_q_kv", 2560, 2048), ("g3_attn_vec", 2048, 2560), ("g3_gating", 2560, 20480), ("g3_linear", 10240, 2560),
    ("g3_vocab", 2560, 262144), ("g3_expert_gating", 768, 6144),
)
# (shape, rows) timed: every quantized shape at the rows its path gives it
# (AR steps: 1 row; the flow expert: 16 rows), the three largest at 16 rows
# too, and 100 and 128 rows once (QUANT_MAX_ROWS routes up to 128 rows to
# the kernels).
QUANT_TIMED = (
    ("mlp_down", 1), ("mlp_down", 16), ("mlp_gate_up", 1), ("mlp_gate_up", 16), ("vocab", 1), ("vocab", 16),
    ("q_attn_vec", 1), ("expert_gate_up", 16), ("expert_down", 16), ("mlp_gate_up", 100), ("mlp_gate_up", 128),
    ("g3_vocab", 1), ("g3_vocab", 16), ("g3_gating", 1), ("g3_linear", 1), ("g3_q_kv", 1), ("g3_attn_vec", 1),
    ("g3_expert_gating", 16),
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
# Tokens of the profiled AR requests, each held to PROFILE_KEPT_SHARE (the
# profiler loses far more records of a 64-token trace).
AR_PROFILE_STEPS = 16
# A profile idles this long on the host before and after its calls: the
# profiler keeps only the device events that fall inside its window, and one
# short timing profile on an H100 once kept none (a dequant time of 0).
PROFILE_PAD_S = 0.01
# A profile whose dequant kernels are counted idles this long on either side
# of its calls instead. The card's kernel timestamps wander against the
# host's clock within a trace (``profile_cuda`` logs by how much), and with
# the 10 ms pad one H100 run kept 2,666 of a 16-token Gemma3 request's 2,737
# dequant kernels.
PROFILE_COUNT_PAD_S = 0.5
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
# The batched serving prefill of two robots (BatchingPolicy): the two raw
# requests of phase 9 tokenize to prompts of these valid lengths in the 180
# prompt slots. Phase 9 checks that the masks its call gives the kernel are
# this case's.
BATCH2_CASE, BATCH2_PROMPT_VALID = "serving_batch2_prefill", (78, 108)
# The prefill behind --token_bucket TOKEN_BUCKET: phase 9's request tokenizes
# to this many valid prompt tokens, and the bucket trims the 180 slots to the
# next multiple of TOKEN_BUCKET. Phase 9 checks the mask as for BATCH2_CASE.
TOKEN_BUCKET = 64
BUCKET_CASE, BUCKET_PROMPT_VALID = "serving_token_bucket_prefill", 92
BUCKET_PREFIX = 512 + math.ceil(BUCKET_PROMPT_VALID / TOKEN_BUCKET) * TOKEN_BUCKET
# Phase 14: LAPGemma3-4B (the lap_gemma3_4b config) at full width. Its
# model-ready requests hold a prompt laid out as Gemma3Tokenizer lays it out:
# BOS, the user turn, G3_SYSTEM ids of a system message, two camera blocks
# (BOI, 256 placeholders, END_IMAGE, newline), G3_TEXT ids of an instruction,
# the end of turn and the model turn: G3_VALID of the 800 slots.
G3_CONFIG = "lap_gemma3_4b"
G3_PROMPT_LEN = 800
G3_SYSTEM, G3_TEXT = 8, 40
G3_VALID = 4 + G3_SYSTEM + 2 + 2 * 259 + G3_TEXT + 5
G3_HEADS = (8, 4, 256)  # gemma3_4b: N, K, H
# Flash-forward cases at the prefills of phase 14's requests (phase 2 holds
# them; phase 14 checks that the path gives the kernel these masks): the
# left-aligned flow prefill and the right-aligned AR prefill with AR_STEPS
# decode slots, on a local (sliding window) and a global layer.
G3_FLOW_LOCAL, G3_FLOW_GLOBAL = "gemma3_flow_prefill_local", "gemma3_flow_prefill_global"
G3_AR_LOCAL, G3_AR_GLOBAL = "gemma3_ar_prefill_local", "gemma3_ar_prefill_global"
G3_TRAIN_CASE = "gemma3_training_local"  # the backward case at the training step's shape and local mask
# The training step: full width, depth cut to one period of 5 local + 1 global
# layers (the full depth's f32 parameters, gradients, Adam moments and EMA
# take ~20 B a parameter x 4.8 B, more than the card holds).
G3_TRAIN_DEPTH = 6
G3_TRAIN_STEPS = 4  # after one warm-up step
G3_AR_REQUESTS = 3
G3_QUANT_FLOW_REQUESTS = 3

# Phase 15: the rest of the model surface at full width: FAST action tokens
# (pi05_replicated, LAP-3B with a 220-slot prompt: a 732-token prefix), the
# pi0 branch (pi0_replicated --model.pi05 False), the VLM-only model
# (vla0_replicated: gemma_2b + So400m, a 390-slot prompt: a 902-token
# prefix) and LoRA training (lap with gemma_2b_lora + gemma_300m_lora). Its
# raw requests tokenize to one prompt a config (a fixed instruction and
# state, the host RNGs seeded with VARIANT_HOST_SEED before each), so phase 2
# holds the masks its calls give the flash forward: the flow prefills, the
# right-aligned AR prefills with AR_STEPS (and AR_FORCED_STEPS) decode slots
# and the LoRA step's prefix call on the fake loader's first batch.
FAST_CONFIG, PI0_CONFIG, VLA0_CONFIG = "pi05_replicated", "pi0_replicated", "vla0_replicated"
FAST_FLOW_CASE, FAST_AR_CASE, PI0_FLOW_CASE = "fast_flow_prefill", "fast_ar_prefill", "pi0_flow_prefill"
VLA0_AR_CASE, VLA0_FORCED_CASE = "vla0_ar_prefill", "vla0_teacher_forced_prefill"
LORA_TRAIN_CASE = "lora_training_step"
# Phase 16: lap_libero (horizon 10) trained from RLDS episodes; without the
# stop-gradient its prefix and action rows are one flash call, [B, 702, 702].
LIBERO_HORIZON = 10
LIBERO_JOINT = 2 * 256 + 180 + LIBERO_HORIZON
RLDS_TRAIN_CASE = "libero_training_step"
VARIANT_REQUESTS = 10
VARIANT_HOST_SEED = 17
LORA_TRAIN_STEPS = 4  # the first allocates; the rest are counted and timed

# Forward cases run twice to show that two calls give the same bits.
# Phase 17's per-rank shapes under tp = 2 (phase 2 holds them).
TP_PREFILL_CASE, TP_G3_PREFILL_CASE, TP_TRAIN_CASE = "tp2_prefill", "tp2_gemma3_flow_prefill", "tp2_training_step"
FWD_DETERMINISM_CASES = (PREFILL_CASE, BATCH2_CASE, BUCKET_CASE, TRAINING_CASE, G3_FLOW_LOCAL, FAST_FLOW_CASE,
                         VLA0_AR_CASE, LORA_TRAIN_CASE, TP_PREFILL_CASE, TP_G3_PREFILL_CASE, TP_TRAIN_CASE)
# Backward cases run twice to show that two calls give the same bits.
DETERMINISM_CASES = (TRAINING_CASE, "gqa_group4_h128", G3_TRAIN_CASE, RLDS_TRAIN_CASE, TP_TRAIN_CASE)


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


def g3_prompt(seed: int):
    """Phase 14's synthetic prompt: (ids [800] int32, valid count)."""
    import numpy as np

    from lap_tpu_torch.models import tokenizer as tk

    rng = np.random.default_rng(seed)
    block = [tk.GEMMA3_BEGIN_IMAGE_TOKEN, *[tk.GEMMA3_IMAGE_TOKEN] * tk.GEMMA3_IMAGE_PLACEHOLDER_LEN,
             tk.GEMMA3_END_IMAGE_TOKEN, tk.GEMMA3_NEWLINE_TOKEN]
    seq = [tk.GEMMA3_BOS_TOKEN, tk.GEMMA3_START_OF_TURN_TOKEN, tk.GEMMA3_USER_TOKEN, tk.GEMMA3_NEWLINE_TOKEN,
           *rng.integers(300, 2000, G3_SYSTEM), tk.GEMMA3_NEWLINE_TOKEN, tk.GEMMA3_NEWLINE_TOKEN, *block * 2,
           *rng.integers(300, 2000, G3_TEXT), tk.GEMMA3_END_OF_TURN_TOKEN, tk.GEMMA3_NEWLINE_TOKEN,
           tk.GEMMA3_START_OF_TURN_TOKEN, tk.GEMMA3_MODEL_TOKEN, tk.GEMMA3_NEWLINE_TOKEN]
    tokens = np.zeros(G3_PROMPT_LEN, np.int32)
    tokens[: len(seq)] = seq
    return tokens, len(seq)


def g3_window() -> int:
    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.training.config import get_config

    return gemma3.get_config(get_config(G3_CONFIG).model.paligemma_variant).sliding_window_size


def g3_prefill_masks(device) -> dict:
    """The masks the flash forward gets at phase 14's prefills, as the model
    builds them: the flow prefix (left-aligned) and the AR prefill
    (right-aligned, AR_STEPS decode slots), each on a local layer (the
    sliding window over RoPE positions against cache slots) and a global
    one, with the image blocks OR'd in."""
    import torch

    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.models.lap_gemma3 import LAPGemma3, left_to_right_align_with_image_mask
    from lap_tpu_torch.ops.masks import make_attn_mask

    tokens, valid = g3_prompt(0)
    image = torch.from_numpy(tokens).to(device)[None] == LAPGemma3.IMAGE_TOKEN
    input_mask = torch.arange(G3_PROMPT_LEN, device=device)[None] < valid
    attn = make_attn_mask(input_mask, torch.zeros_like(input_mask))
    window, out = g3_window(), {}
    for name, is_global in ((G3_FLOW_LOCAL, False), (G3_FLOW_GLOBAL, True)):
        out[name] = gemma3.effective_mask(attn, torch.cumsum(input_mask, dim=1) - 1, G3_PROMPT_LEN,
                                          is_global=is_global, window=window, image_mask=image)
    x = torch.zeros((1, G3_PROMPT_LEN, 1), device=device)
    _, aligned, attn_al, image_al = left_to_right_align_with_image_mask(x, input_mask, attn, image)
    attn_al = torch.nn.functional.pad(attn_al, (0, AR_STEPS))
    for name, is_global in ((G3_AR_LOCAL, False), (G3_AR_GLOBAL, True)):
        out[name] = gemma3.effective_mask(attn_al, torch.cumsum(aligned, dim=1) - 1, G3_PROMPT_LEN + AR_STEPS,
                                          is_global=is_global, window=window, image_mask=image_al)
    out["ar_valid_rows"] = aligned
    return {k: v.contiguous() for k, v in out.items()}


def g3_training_mask(batch, device, *, is_global: bool = False):
    """The mask of one layer of the LAPGemma3-4B training step's joint call
    (800 prompt tokens, the synthetic batch's image blocks and
    language-action span, 16 action tokens), as ``compute_loss`` builds it,
    [batch, 816, 816]."""
    import torch

    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.models.lap_gemma3 import LAPGemma3
    from lap_tpu_torch.training.config import get_config
    from lap_tpu_torch.training.train import fake_train_batch

    obs, _ = fake_train_batch(get_config(G3_CONFIG).model, 1, device=device)
    prefix, langact = obs.tokenized_prompt_mask.to(torch.bool), obs.tokenized_langact_mask.to(torch.bool)
    suffix = torch.ones((1, ACTION_HORIZON), dtype=torch.bool, device=device)
    suffix_ar = torch.zeros_like(suffix)
    suffix_ar[:, 0] = True
    action_view = prefix & ~langact  # LAPGemma3._build_prefix_action_mask
    # Neither method reads the model: called on the class.
    mask = LAPGemma3._build_combined_attention_mask(None, prefix, langact, action_view, suffix, suffix_ar)
    positions = LAPGemma3._build_combined_positions(None, prefix, action_view, suffix)
    image = torch.nn.functional.pad(obs.tokenized_prompt == LAPGemma3.IMAGE_TOKEN, (0, ACTION_HORIZON))
    mask = gemma3.effective_mask(mask, positions, mask.shape[-1], is_global=is_global, window=g3_window(),
                                 image_mask=image)
    return mask.expand(batch, -1, -1).contiguous()


def kernel_cases(device):
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    n3, k3, h3 = G3_HEADS
    g3 = g3_prefill_masks(device)

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
        (BATCH2_CASE, (2, LAP_PREFIX, LAP_PREFIX, 8, 1, 256),
         prefix_lm_mask([512 + n for n in BATCH2_PROMPT_VALID], [0, 0], LAP_PREFIX, device)),
        (BUCKET_CASE, (1, BUCKET_PREFIX, BUCKET_PREFIX, 8, 1, 256),
         prefix_lm_mask([512 + BUCKET_PROMPT_VALID], [0], BUCKET_PREFIX, device)),
        ("ar_prefill_right_aligned", (1, LAP_PREFIX, LAP_PREFIX + AR_STEPS, 8, 1, 256), ar_prefill_mask(device)),
        ("b2_unequal_padding", (2, 300, 300, 8, 1, 256), prefix_lm_mask([250, 180], [30, 12], 300, device)),
        ("gqa_k2", (1, 256, 256, 8, 2, 256), rand_mask(1, 256, 256, 0.7)),
        ("gqa_k8", (1, 200, 200, 8, 8, 256), rand_mask(1, 200, 200, 0.7)),
        ("head_dim_128", (1, 384, 384, 8, 1, 128), prefix_lm_mask([300], [20], 384, device)),
        ("fully_masked_rows", (1, 257, 257, 8, 1, 256), rand_mask(1, 257, 257, 0.5, dead_rows=40)),
        ("ragged_t_s", (1, 100, 333, 4, 1, 256), rand_mask(1, 100, 333, 0.5)),
        *((name, (1, G3_PROMPT_LEN, g3[name].shape[-1], n3, k3, h3), g3[name])
          for name in (G3_FLOW_LOCAL, G3_FLOW_GLOBAL, G3_AR_LOCAL, G3_AR_GLOBAL)),
        *variant_kernel_cases(device),
        # One rank's heads under tp = 2 (phase 17): LAP's prefill with 4 query
        # heads on its 1 KV head, LAPGemma3-4B's with 4 on 2.
        (TP_PREFILL_CASE, (1, LAP_PREFIX, LAP_PREFIX, 8 // TP_RANKS, 1, 256), path_mask),
        (TP_G3_PREFILL_CASE, (1, G3_PROMPT_LEN, g3[G3_FLOW_LOCAL].shape[-1], n3 // TP_RANKS, k3 // TP_RANKS, h3),
         g3[G3_FLOW_LOCAL]),
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


def time_gemma3_flash_forward(device) -> dict:
    """The flash forward at phase 14's prefills (B=1, T=800, K=4, H=256, the
    local-layer masks of the flow and the AR prefill) by device time, beside
    its plain version, SDPA's device time (a yardstick) and the bound."""
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(18)
    masks = g3_prefill_masks(device)
    n, kh, h = G3_HEADS
    out = {}
    for name in (G3_FLOW_LOCAL, G3_AR_LOCAL):
        mask = masks[name]
        t, s = mask.shape[1:]
        q = torch.randn((1, t, n, h), generator=g, device=device).to(torch.bfloat16)
        k, v = (torch.randn((1, s, kh, h), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
        device_ms = device_ms_per_call([lambda: fa.flash_attention_forward(q, k, v, mask)], iters=50)
        plain_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, mask), iters=10)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = device_ms_per_call(
            [lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)], iters=50)
        bound_ms, bound_by, flops_ms, bytes_ms = flash_forward_bound(mask, q, k, v)
        out[name] = dict(device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"timing flash_attention_fwd {name} B1 T{t} S{s} N{n} K{kh} H{h}: device_ms={device_ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms(sdpa, device time)={library_ms:.5f} bound_ms={bound_ms:.5f} "
            f"({bound_by}: flops -> {flops_ms:.5f} ms, bytes -> {bytes_ms:.5f} ms; {int(mask.sum())} pairs)")
    return out


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


def training_mask(batch, device, horizon=ACTION_HORIZON, *, joint_call=False):
    """The mask of one LAP-3B training step's flash call, as the model passes
    it. With the action expert's gradient stopped at the VLM (``lap``) the
    prefix is a call of its own: the first 692 rows ([B, 692, 708], not
    contiguous) of the joint mask. Without (``lap_libero``, horizon 10:
    ``joint_call``) the joint [B, 702, 702] mask is one call. Image and
    prompt tokens bidirectional, the language-action tokens (prompt slot 8
    on) causal, the action-token columns all false for the prefix rows; the
    action rows see every key."""
    import torch

    prefix = prefix_lm_mask([LAP_PREFIX], [PROMPT_LEN - LANGACT_START], LAP_PREFIX, device)
    joint = torch.nn.functional.pad(prefix, (0, horizon, 0, horizon))
    joint[:, LAP_PREFIX:] = True
    joint = joint.expand(batch, -1, -1).contiguous()
    return joint if joint_call else joint[:, :LAP_PREFIX]


def training_queries(batch, generator, device, heads: int = 8):
    """Queries (or an output gradient's worth of values) laid out as the model
    lays them out for the prefix call: the first 692 rows of the joint
    [B, 708, heads, 256] tensor, so the batch stride is that of 708 rows."""
    import torch

    joint = torch.randn((batch, LAP_PREFIX + ACTION_HORIZON, heads, 256), generator=generator, device=device)
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
        (G3_TRAIN_CASE, (TRAIN_BATCH, G3_PROMPT_LEN + ACTION_HORIZON, G3_PROMPT_LEN + ACTION_HORIZON, *G3_HEADS),
         g3_training_mask(TRAIN_BATCH, device)),
        (LORA_TRAIN_CASE, (TRAIN_BATCH, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256),
         lora_training_mask(device)),
        (RLDS_TRAIN_CASE, (TRAIN_BATCH, LIBERO_JOINT, LIBERO_JOINT, 8, 1, 256),
         training_mask(TRAIN_BATCH, device, LIBERO_HORIZON, joint_call=True)),
        # The training call of one rank under tp = 2: 4 query heads on 1 KV head.
        (TP_TRAIN_CASE, (TRAIN_BATCH, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8 // TP_RANKS, 1, 256),
         training_mask(TRAIN_BATCH, device)),
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
        if name in (TRAINING_CASE, LORA_TRAIN_CASE, TP_TRAIN_CASE):
            q = training_queries(b, g, device, n)
        else:
            q = torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16)
        k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        # The output gradient arrives as a slice of the joint tensor's too.
        dout = (training_queries(b, g, device, n) if name in (TRAINING_CASE, LORA_TRAIN_CASE, TP_TRAIN_CASE)
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


def time_delta_library(out, dout, delta):
    """Yardstick only: one PyTorch call for delta = sum_h dO * O with f32
    accumulation of the bf16 inputs and an f32 result, ``torch.bmm`` of
    [B*T*N, 1, H] by [B*T*N, H, 1] with ``out_dtype=torch.float32`` (a cast
    to f32 first would be a second call; a bf16 ``vecdot`` rounds the result
    to bf16). Held to the delta check's bound against the kernel; None, with
    the reason logged, where this PyTorch has no such call."""
    import torch

    b, t, n, h = out.shape

    def call():
        return torch.bmm(out.reshape(-1, 1, h), dout.reshape(-1, h, 1), out_dtype=torch.float32)

    try:
        got = call().view(b, t, n).transpose(1, 2)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log(f"timing flash_attention_bwd_delta: no single PyTorch call (bmm with out_dtype: {e}); library_ms=None")
        return None
    bound = 2 * (h - 1) * 2.0**-24 * (dout.float() * out.float()).abs().sum(-1).transpose(1, 2)
    err = (got - delta).abs()
    log(f"timing flash_attention_bwd_delta: library call torch.bmm(out_dtype=float32) vs the kernel "
        f"max_abs_err={err.max().item():.3e} (bound at least {bound.min().item():.3e})")
    if not bool((err <= bound).all()):
        raise AssertionError("the delta yardstick computes another function than the kernel")
    return device_ms_per_call([call], iters=50)


def time_flash_backward(device, batch, *, gemma3: bool = False):
    """The backward at the training shape: the delta kernel, the dQ kernel and
    the dK/dV kernel with its group-sum pass each alone (from a given delta;
    CUDA events, except the delta kernel and the pass: profiler device time),
    the pass alone, and the whole ``flash_attention_backward`` as the path
    calls it (the output gradient's copy, delta once, dQ, dK/dV and the pass),
    beside their bounds, the plain versions and autograd through
    ``F.scaled_dot_product_attention``. With ``gemma3``: at the LAPGemma3-4B
    training shape (T = S = 816, K = 4, contiguous q) and its local mask."""
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(5)
    if gemma3:
        b, t, s = batch, G3_PROMPT_LEN + ACTION_HORIZON, G3_PROMPT_LEN + ACTION_HORIZON
        n, kh, h = G3_HEADS
        mask = g3_training_mask(b, device)
        q, dout = (torch.randn((b, t, n, h), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    else:
        b, t, s, n, kh, h = batch, LAP_PREFIX, LAP_PREFIX + ACTION_HORIZON, 8, 1, 256
        mask = training_mask(b, device)
        q = training_queries(b, g, device)
        dout = training_queries(b, g, device)  # a slice of the joint tensor, as on the path
    k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
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
    delta_library_ms = time_delta_library(out, dout_c, delta)
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
        library = {"group_sum": group_sum_library_ms, "delta": delta_library_ms}.get(name)
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

    def quantize_int4(w):  # the group the serving path takes for this K (128 at K = 768)
        return i4.quantize_int4(w, group_size=int4_group(w.shape[0]))

    return (
        ("int8_matmul", i8, i8.quantize_int8, i8.int8_matmul, i8.int8_matmul_plain),
        ("int4_matmul", i4, quantize_int4, i4.int4_matmul, i4.int4_matmul_plain),
    )


def int4_group(k: int) -> int:
    from lap_tpu_torch.models.lora import _int4_group

    return _int4_group(k)


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


def profile_cuda(run, what: str, pad_s: float = PROFILE_PAD_S):
    """Run ``run()`` under the profiler, with ``pad_s`` of idle time on
    either side, until the trace holds device events, at most
    ``PROFILE_ATTEMPTS`` times. Returns (the CUDA kernels of
    ``key_averages()``, the host's ms for ``run()`` with a final sync);
    raises if every attempt held none. With a pad longer than
    ``PROFILE_PAD_S`` it logs where the first and last kernels fall on the
    profiler's clock against the host's start of ``run()`` and its sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            started_ns = time.time_ns()
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            synced_ns = time.time_ns()
            wall_ms = (time.monotonic() - t0) * 1e3
            time.sleep(pad_s)
        events = [e for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        if events:
            if pad_s > PROFILE_PAD_S:
                spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA]
                log(f"profile: {what}: the first kernel starts {(min(s for s, _ in spans) - started_ns) / 1e6:.3f} ms "
                    f"after the host starts the call, the last ends {(max(e for _, e in spans) - synced_ns) / 1e6:.3f} "
                    f"ms after the host's sync (the profiler's clock; the window reaches {pad_s * 1e3:.0f} ms "
                    f"beyond both)")
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
    weight = k * n + n * 4 if name == "int8_matmul" else k * n // 2 + (k // int4_group(k)) * n * 4
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
                plan = i8.launch_plan(name[:4], m, k, n, int4_group(k) if name == "int4_matmul" else None, sms)
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


def profile_one_request(policy, request, what: str = "infer", tokens: int = 0, pad_s: float = PROFILE_PAD_S) -> int:
    events, wall_ms = profile_cuda(lambda: policy.infer(request), what, pad_s)
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


# ---------------------------------------------------------------------------
# Serving stack: raw requests, a checkpoint directory, batching, the recorder
# ---------------------------------------------------------------------------

SERVING_PROMPTS = (
    "pick up the red cup and put it in the sink",
    "open the top drawer",
    "move the blue block to the left of the bowl, then push the bowl forward",
    "close the microwave door",
)
DEFAULT_PROMPT = "do something useful"
SERVING_STACK_REQUESTS = 10
SERVING_AR_REQUESTS = 2


def raw_request(seed: int, config, *, prompt: str | None = "", wrist: bool = True) -> dict:
    """What a robot sends: two 224^2 uint8 cameras under the keys CoTInputs
    reads, a state vector and an instruction string (``None``: no prompt,
    the server's default applies; ``""``: one of ``SERVING_PROMPTS``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = config.image_resolution
    observation = {k: rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for k in config.image_keys}
    if not wrist:
        del observation[config.image_keys[1]]
    observation["state"] = rng.uniform(-1, 1, config.action_dim).astype(np.float32)
    request = {"observation": observation}
    if prompt is not None:
        request["prompt"] = prompt or SERVING_PROMPTS[seed % len(SERVING_PROMPTS)]
    return request


def serving_norm_stats(dim: int) -> dict:
    """Seeded quantile stats for the state and the actions (a checkpoint's
    assets/<asset_id>/norm_stats.json)."""
    import numpy as np

    from lap_tpu_torch.policies.model_transforms import NormStats

    rng = np.random.default_rng(11)
    out = {}
    for key in ("state", "actions"):
        q01 = rng.uniform(-0.5, -0.05, dim).astype(np.float32)
        q99 = (q01 + rng.uniform(0.1, 1.0, dim)).astype(np.float32)
        out[key] = NormStats(mean=(q01 + q99) / 2, std=(q99 - q01) / 4, q01=q01, q99=q99)
    return out


def release() -> None:
    """Give the card back the memory of the models the caller dropped."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def flash_masks():
    """Yields the list of the masks that the flash forward is given inside
    the block, one for each call."""
    from lap_tpu_torch.ops import flash_attention as fa

    seen, forward = [], fa.flash_attention_forward

    def recording(q, k, v, mask, **kw):
        seen.append(mask)
        return forward(q, k, v, mask, **kw)

    fa.flash_attention_forward = recording
    try:
        yield seen
    finally:
        fa.flash_attention_forward = forward


def check_path_masks(seen, case_mask, what: str) -> None:
    """Every mask the path gave the flash forward is ``case_mask``, the mask
    of a phase-2 kernel case, with its batch rows in any order (each row of
    the kernel's grid is independent of the others)."""
    import torch

    orders = [case_mask, case_mask.flip(0)]
    if not seen or not all(any(m.shape == c.shape and torch.equal(m, c) for c in orders) for m in seen):
        raise AssertionError(f"serving stack: {what}: the flash forward's masks {[tuple(m.shape) for m in seen]} "
                             f"are not those of its kernel case {tuple(case_mask.shape)}")
    log(f"serving stack: {what}: the {len(seen)} masks the flash forward was given are its kernel case's")


def evict_from_page_cache(path) -> None:
    """Write the file's dirty pages back and drop its pages from the host's
    page cache, so that the next read comes from the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def page_cache_share(path) -> float:
    """Share of the file's pages that the host's page cache holds (mincore)."""
    import ctypes
    import mmap

    import numpy as np

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    size = os.path.getsize(path)
    vec = np.zeros(-(-size // mmap.PAGESIZE), np.uint8)
    with open(path, "rb") as f:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, f.fileno(), 0)
    if addr == ctypes.c_void_p(-1).value:
        raise OSError(ctypes.get_errno(), f"mmap of {path} failed")
    try:
        if libc.mincore(ctypes.c_void_p(addr), size, vec.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise OSError(ctypes.get_errno(), f"mincore of {path} failed")
    finally:
        libc.munmap(ctypes.c_void_p(addr), size)
    return float((vec & 1).mean())


def run_serving_stack(model, config, device):
    """Phase 9: the serving stack at full width. A checkpoint directory
    written from the serving model (``checkpoints.save_params``, bf16, and
    seeded norm stats), restored through ``serve_policy.create_policy`` /
    ``create_trained_policy_ar``; raw requests through the transforms, the
    model and the output stack: flow, AR with int8 copies, two robots behind
    ``BatchingPolicy``, and the token bucket behind ``PolicyRecorder``.
    Returns the launch counts and the phase's numbers."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from lap_tpu_torch import native
    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.policy import Policy, _stack_batch, _trim_token_pad, unflatten_record
    from lap_tpu_torch.serving import serve_policy
    from lap_tpu_torch.training import checkpoints
    from lap_tpu_torch.training.config import get_config

    depth = len(model.llm.layers)
    lap = get_config("lap")
    case_masks = {name: mask for name, _, mask in kernel_cases(device)}
    stats = {}
    launches = {"flash": 0, "int8": 0}
    with tempfile.TemporaryDirectory(prefix="lap_ckpt_") as ckpt:
        ckpt_dir = Path(ckpt)
        t0 = time.monotonic()
        path = checkpoints.save_params(model, ckpt_dir / "params")
        checkpoints.save_norm_stats(ckpt_dir / "assets" / lap.data.asset_id / "norm_stats.json",
                                    serving_norm_stats(config.action_dim))
        stats["write_s"] = time.monotonic() - t0
        stats["write_bytes"] = path.stat().st_size
        log(f"serving stack: wrote {path} ({stats['write_bytes']} bytes, bf16) and the norm stats in "
            f"{stats['write_s']:.2f} s")
        native.get_lib()
        log(f"serving stack: native host ops {native.status()}")

        def args(*extra):
            return serve_policy.parse_args(["--env", "LAP", "--checkpoint_dir", str(ckpt_dir), "--allow_test_vocab",
                                            "--default_prompt", DEFAULT_PROMPT, "--device", str(device), *extra])

        # Flow: raw requests through the restored policy. The first restore
        # comes after the params file is synced and its pages dropped from
        # the host's page cache, and the share of its pages still cached
        # (mincore) is reported beside it: a host that honours
        # posix_fadvise reads the file from the disk; a filesystem that
        # ignores it (the card's sandbox, a 9p root) keeps it cached. The
        # second restore reads it from the cache.
        t0 = time.monotonic()
        evict_from_page_cache(path)
        stats["sync_s"] = time.monotonic() - t0
        stats["page_cache_share_at_restore"] = page_cache_share(path)
        t0 = time.monotonic()
        policy = serve_policy.create_policy(args())
        torch.cuda.synchronize()
        stats["restore_s"] = time.monotonic() - t0
        stats["page_cache_share_at_restore_again"] = page_cache_share(path)
        t0 = time.monotonic()
        again = serve_policy.create_policy(args())
        torch.cuda.synchronize()
        stats["restore_again_s"] = time.monotonic() - t0
        del again
        release()
        log(f"serving stack: create_policy (LAP preset, restore from {stats['write_bytes']} bytes included) "
            f"in {stats['restore_s']:.2f} s with {stats['page_cache_share_at_restore']:.3f} of the file in the "
            f"page cache (after {stats['sync_s']:.2f} s of fsync and eviction), and again in "
            f"{stats['restore_again_s']:.2f} s with {stats['page_cache_share_at_restore_again']:.3f} of it there")
        requests = [raw_request(500 + i, config, prompt=None if i == 1 else "", wrist=i != 2)
                    for i in range(SERVING_STACK_REQUESTS)]
        policy.infer(requests[0])  # first call at these shapes
        reset_launch_counters()
        latencies, per_request, input_ms, output_ms = [], [], [], []
        for req in requests:
            before = serving_launches()
            out = policy.infer(req)
            per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            latencies.append(out["policy_timing"]["infer_ms"])
            actions = out["actions"]
            if actions.shape != (config.action_horizon, config.action_dim) or not np.isfinite(actions).all():
                raise AssertionError(f"serving stack: bad actions {actions.shape}")
        launches["flash"] += serving_launches()[0]
        if any(c != (depth, 0, 0) for c in per_request):
            raise AssertionError(f"serving stack: expected {depth} flash and no dequant launches per raw "
                                 f"request, got {per_request}")
        # The host's share: the input stack and the output stack alone.
        for req in requests:
            t0 = time.monotonic()
            prepared = policy._prepare(req)
            input_ms.append((time.monotonic() - t0) * 1e3)
            t0 = time.monotonic()
            out = policy._output({"state": prepared["state"], "actions": actions})
            output_ms.append((time.monotonic() - t0) * 1e3)
        normalised = policy._output({"state": prepared["state"], "actions": np.zeros_like(actions)})["actions"]
        q01, q99 = (getattr(serving_norm_stats(config.action_dim)["actions"], k) for k in ("q01", "q99"))
        if not np.allclose(normalised, (q01 + q99) / 2, atol=1e-5):
            raise AssertionError("serving stack: the output stack does not map 0 to the middle of q01..q99")
        stats["p50_ms"], stats["p90_ms"] = percentiles(latencies)
        stats["input_stack_ms_p50"] = statistics.median(input_ms)
        stats["output_stack_ms_p50"] = statistics.median(output_ms)
        log(f"serving stack: {len(requests)} raw flow requests (one without a prompt, one without a wrist "
            f"camera), {depth} flash launches each, actions {actions.shape} in physical units; infer "
            f"p50_ms={stats['p50_ms']:.3f} p90_ms={stats['p90_ms']:.3f} all_ms={[round(x, 3) for x in latencies]}; "
            f"host: input stack p50_ms={stats['input_stack_ms_p50']:.3f} "
            f"all_ms={[round(x, 3) for x in input_ms]}, output stack p50_ms={stats['output_stack_ms_p50']:.4f}")

        # Restore fidelity: one transformed request, the same explicit noise.
        obs = CoTObservation.from_dict(_stack_batch([policy._prepare(requests[3])]), device=device)
        noise = torch.randn((1, config.action_horizon, config.action_dim),
                            generator=torch.Generator(device=device).manual_seed(12), device=device)
        restored, in_memory = policy._model.sample_actions(obs, noise=noise), model.sample_actions(obs, noise=noise)
        if not torch.equal(restored, in_memory):
            raise AssertionError("serving stack: the restored model's actions differ from the in-memory model's "
                                 f"(max abs {(restored - in_memory).abs().max().item()})")
        log("serving stack: restored vs in-memory model, one transformed request, same noise: bit-equal actions")
        del policy, obs, restored
        release()

        # AR with int8 copies through create_trained_policy_ar.
        t0 = time.monotonic()
        ar_policy = policy_config.create_trained_policy_ar(
            lap, ckpt_dir, default_prompt=DEFAULT_PROMPT, max_decoding_steps=AR_STEPS, allow_test_vocab=True,
            quantize="int8", device=device)
        torch.cuda.synchronize()
        stats["ar_int8_restore_s"] = time.monotonic() - t0
        decoded = []
        sample_tokens = ar_policy._model.sample_tokens

        def recording_sample_tokens(*a, **kw):
            tokens = sample_tokens(*a, **kw)
            decoded.append(tokens.cpu())
            return tokens

        ar_policy._model.sample_tokens = recording_sample_tokens
        ar_requests = [raw_request(600 + i, config) for i in range(SERVING_AR_REQUESTS)]
        reset_launch_counters()
        ar_counts, ar_ms = [], []
        for req in ar_requests:
            before = serving_launches()
            out = ar_policy.infer(req)
            counts = tuple(a - b for a, b in zip(serving_launches(), before))
            tokens = decoded[-1][0].numpy()
            eos = np.nonzero(tokens == model.EOS_TOKEN)[0]
            n = int(eos[0]) + 1 if eos.size else AR_STEPS
            expected = (depth, (4 * depth + 1) * n + 1, 0)
            if counts != expected:
                raise AssertionError(f"serving stack AR int8: {n} tokens decoded, expected {expected} (flash, int8, "
                                     f"int4) launches, got {counts}")
            if not isinstance(out["reasoning"], str) or not np.isfinite(np.asarray(out["actions"])).all():
                raise AssertionError(f"serving stack AR int8: bad output {out}")
            ar_counts.append(counts)
            ar_ms.append(out["policy_timing"]["infer_ms"])
            log(f"serving stack: AR int8 raw request, {n} tokens decoded, (flash, int8, int4) launches {counts}, "
                f"infer_ms={ar_ms[-1]:.3f}, reasoning={out['reasoning'][:60]!r}, actions {np.asarray(out['actions'])}")
        launches["flash"] += sum(c[0] for c in ar_counts)
        launches["int8"] += sum(c[1] for c in ar_counts)
        stats["ar_int8_infer_ms"] = ar_ms
        del ar_policy, sample_tokens, recording_sample_tokens
        release()

        # Two robots at once behind BatchingPolicy: one model call.
        batcher = serve_policy.create_policy(args("--max_batch", "2", "--batch_window_ms", "2000"))
        inner = batcher._policy
        pair = [raw_request(700, config, prompt=SERVING_PROMPTS[1]), raw_request(701, config, prompt=SERVING_PROMPTS[2])]
        batcher.infer(pair[0])  # first call at batch 1
        results = [None, None]
        barrier = threading.Barrier(2)

        def client(i):
            barrier.wait()
            results[i] = batcher.infer(pair[i])

        reset_launch_counters()
        # Each request draws once from numpy's global RNG for the wrist
        # dropout of the lap config: a seed whose first two draws keep both
        # wrist cameras, so that the kernel gets BATCH2_CASE's mask.
        np.random.seed(16)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        with flash_masks() as seen:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        batch_launches = serving_launches()
        batcher.close()
        sizes = [r["policy_timing"]["batch_size"] for r in results]
        if sizes != [2, 2] or batch_launches != (depth, 0, 0) or batcher.stats["largest_batch"] != 2:
            raise AssertionError(f"serving stack batching: batch sizes {sizes}, launches {batch_launches}, "
                                 f"stats {batcher.stats}")
        launches["flash"] += batch_launches[0]
        prepared = [inner._prepare(r) for r in pair]
        lengths = [int(p["tokenized_prompt_mask"].sum()) for p in prepared]
        noise2 = torch.randn((2, config.action_horizon, config.action_dim),
                             generator=torch.Generator(device=device).manual_seed(13), device=device)
        both = inner._model.sample_actions(CoTObservation.from_dict(_stack_batch(prepared), device=device),
                                           noise=noise2)
        row_err = []
        for i, p in enumerate(prepared):
            alone = inner._model.sample_actions(CoTObservation.from_dict(_stack_batch([p]), device=device),
                                                noise=noise2[i : i + 1])
            row_err.append(((both[i] - alone[0]).norm() / alone[0].norm()).item())
        stats["batch2_infer_ms"] = [r["policy_timing"]["infer_ms"] for r in results]
        log(f"serving stack: two robots at once behind BatchingPolicy: one call, batch sizes {sizes}, (flash, int8, "
            f"int4) launches {batch_launches}, infer_ms={[round(x, 3) for x in stats['batch2_infer_ms']]}, prompts "
            f"of {lengths} valid tokens; batched rows vs each alone at the same noise "
            f"rel_err={[f'{e:.3e}' for e in row_err]} (tol {PATH_REL_TOL})")
        if max(row_err) > PATH_REL_TOL:
            raise AssertionError(f"serving stack batching: batched rows differ from single rows: {row_err}")
        check_path_masks(seen, case_masks[BATCH2_CASE], "two robots behind BatchingPolicy")
        del batcher, inner, both, alone
        release()

        # The token bucket behind the recorder, against the untrimmed request
        # at the same noise (the same seed and request step).
        with tempfile.TemporaryDirectory(prefix="lap_records_") as record_dir:
            recorder = serve_policy.create_policy(args("--token_bucket", str(TOKEN_BUCKET), "--record_dir", record_dir))
            bucketed = recorder._policy
            inputs, outputs = policy_config._build_transform_stacks(
                lap, policy_config._load_norm_stats(ckpt_dir, lap.data.asset_id), default_prompt=DEFAULT_PROMPT,
                ar=False)
            untrimmed = Policy(bucketed._model, input_transforms=inputs, output_transforms=outputs, seed=0)
            request = raw_request(800, config)
            trimmed_len = _trim_token_pad(_stack_batch([bucketed._prepare(request)]), TOKEN_BUCKET)[
                "tokenized_prompt"].shape[-1]
            reset_launch_counters()
            np.random.seed(14)  # the wrist camera kept, as in BUCKET_CASE
            with flash_masks() as seen:
                out = recorder.infer(request)
            bucket_launches = serving_launches()
            np.random.seed(14)
            ref = untrimmed.infer(request)
            err = float(np.linalg.norm(out["actions"] - ref["actions"]) / np.linalg.norm(ref["actions"]))
            flat = dict(np.load(Path(record_dir) / "step_000000.npz"))
            recorded = unflatten_record(flat, "obs")
            same = (str(recorded["prompt"]) == request["prompt"] and all(
                np.array_equal(recorded["observation"][k], v) for k, v in request["observation"].items())
                and set(recorded["observation"]) == set(request["observation"])
                and np.array_equal(unflatten_record(flat, "out")["actions"], out["actions"]))
            log(f"serving stack: --token_bucket {TOKEN_BUCKET} trims the prompt to {trimmed_len} of "
                f"{config.max_token_len} slots, (flash, int8, int4) launches {bucket_launches}; actions vs the "
                f"untrimmed request at the same noise rel_err={err:.3e} (tol {PATH_REL_TOL}); the recorded .npz "
                f"unflattens to the request and its response: {same}")
            if bucket_launches != (depth, 0, 0) or trimmed_len >= config.max_token_len or err > PATH_REL_TOL or not same:
                raise AssertionError("serving stack: token bucket or recorder check failed")
            check_path_masks(seen, case_masks[BUCKET_CASE], f"--token_bucket {TOKEN_BUCKET}")
            launches["flash"] += bucket_launches[0]
            stats["token_bucket_rel_err"] = err
            del recorder, bucketed, untrimmed
            release()
        # Phase 17a serves this checkpoint directory over two ranks.
        launches["parallel"] = run_tp_serving(ckpt_dir, config, device)
    stats["launches"] = launches
    stats["native"] = native.status()
    print(json.dumps({"serving_stack": stats}), flush=True)
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
    totals, kept = {}, {}
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
        # One profiled request of AR_PROFILE_STEPS tokens a mode is the
        # report's and the check's: Kineto drops the GPU records that it
        # places outside a trace's window ("Out-of-range" in its log with
        # KINETO_LOG_LEVEL=1), far more of them in a 64-token trace. One
        # kernel per dequant call: the profile holds as many dequant kernels
        # as the counters count calls, less the few records a trace drops at
        # its window's edges; a second kernel per call would double the count.
        short = ARPolicy(model, max_decoding_steps=AR_PROFILE_STEPS, stop_on_eos=False, seed=0)
        calls = (4 * depth + 1) * AR_PROFILE_STEPS + 1 if mode != "bf16" else 0
        profiled = profile_one_request(short, requests[0], what=f"AR request ({mode}, {AR_PROFILE_STEPS} tokens)",
                                       tokens=AR_PROFILE_STEPS, pad_s=PROFILE_COUNT_PAD_S)
        kept[mode] = {"tokens": AR_PROFILE_STEPS, "dequant_kernels": profiled, "dequant_calls": calls}
        log(f"profile: AR {mode}, {AR_PROFILE_STEPS} tokens: dequant kernels in the profile {profiled} "
            f"for {calls} dequant calls")
        if not PROFILE_KEPT_SHARE * calls <= profiled <= calls:
            raise AssertionError(f"{mode} AR: the profile of {AR_PROFILE_STEPS} tokens holds {profiled} "
                                 f"dequant kernels for {calls} dequant calls")
    print(json.dumps({"ar_profile": kept}), flush=True)
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


def check_ar_kernels_against_plain(model, config, device, request=None):
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

    request = make_request(400, config) if request is None else request
    obs = CoTObservation.from_dict(_stack_batch([request]), device=device)
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


# ---------------------------------------------------------------------------
# The training entry points: train.main, resume, validation, eval, serving
# ---------------------------------------------------------------------------

# The phase's parameter dtype and what it trains, fixed here, not at run
# time. A step directory holds the parameters, the Adam moments and the EMA of
# the trained parameters (the moments take the parameter's dtype), and the
# EMA view under params/; retention keeps the previous step until the next is
# whole. The H100 hosts this script is run on stop a run once it has written
# 45 GiB to their disk, deleted files included, and phase 9 writes 6.7 GB of
# them. Training all 3.35 B parameters, a step directory is 33.5 GB in
# bfloat16 (67 GB in float32): one save fits, two do not (such a run was
# stopped during its second save). With the VLM frozen (``--freeze_vlm
# true``, a field of both packages; the action expert and the projections,
# 0.31 B parameters, train), a step directory holds all 3.35 B parameters and
# the EMA view of them at full width and depth: 16.0 GB in bfloat16 (about
# twice that in float32, two of which do not fit either). Phases 11-12 keep
# timing the float32 defaults with every parameter trained.
TRAIN_PHASE_DTYPE = "bfloat16"
TRAIN_PHASE_FREEZE_VLM = "true"
TRAIN_PHASE_STEPS = 2  # run 1 takes these steps and saves at the last
# The card's machine stops a call that has written 45 GiB (48.3 GB) to its
# disk. Phases 13 and 16 each write two step directories (bf16, VLM frozen)
# of ~3.8 + 0.68 x depth GB (9.91 GB at depth 9, 16.0 GB at 18); phase 9
# writes 6.7 GB and phase 14 9.6 GB. At depth 9 the four step directories
# alone would be 39.6 GB (55.9 GB in all); at 2 they are ~20.7 GB (~37 GB in
# all, under 40). Both phases run their config at full width with both
# experts cut to this depth (variants registered as `<name>_depth<N>`).
TRAIN_PHASE_DEPTH = 2


def state_checksums(state, whole=None) -> dict:
    """Two int64 sums of every tensor's bits (plain, and weighted by the
    position mod 65521, so that a swap of two values shows): parameters,
    the optimizer's buffers (Adam mu and nu), EMA, with the step and the
    optimizer's count. ``whole(name, shard)`` makes a sharded state's
    tensors whole first (a collective every rank joins), one at a time."""
    import torch

    tensors = {f"params/{n}": (n, p) for n, p in state.params.items()}
    for kind, buffers in state.opt_state.buffers().items():
        tensors.update({f"{kind}/{n}": (n, t) for n, t in zip(state.trainable, buffers, strict=True)})
    tensors.update({f"ema/{n}": (n, t) for n, t in (state.ema_params or {}).items()})
    sums = []
    chunk = 1 << 26
    with torch.no_grad():
        for name, t in tensors.values():
            if whole is not None:
                t = whole(name, t)
            flat = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
            plain = torch.zeros((), dtype=torch.int64, device=t.device)
            weighted = torch.zeros((), dtype=torch.int64, device=t.device)
            for start in range(0, flat.numel(), chunk):
                part = flat[start:start + chunk].to(torch.int64)
                weight = torch.arange(start, start + part.numel(), device=t.device) % 65521 + 1
                plain += part.sum()
                weighted += (part * weight).sum()
            sums.append(torch.stack([plain, weighted]))
        values = torch.stack(sums).cpu().tolist()
    out = dict(zip(tensors, map(tuple, values), strict=True))
    out["step"], out["adam_count"] = state.step, state.opt_state.count
    return out


def flash_and_backward_launches() -> tuple[int, int, int, int, int]:
    from lap_tpu_torch.ops import flash_attention as fa

    return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_delta, fa.launches_bwd_group_sum)


def run_train_entry_points(device):
    """Phase 13: ``train.main`` at full width (the ``lap`` config, batch
    TRAIN_BATCH from the fake loader, TRAIN_PHASE_DTYPE parameters): run 1
    takes TRAIN_PHASE_STEPS steps and saves; run 2 resumes and takes no step
    (its restored state against run 1's, bit for bit); run 3 resumes, takes a
    step (its loss against the loss run 1's state gave the same batch, bit for
    bit) with a validation step, and saves; ``eval.main`` over the last step;
    ``create_trained_policy`` on that step directory in bf16 and int8. The
    run directory is deleted at the end, also on failure."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lap_tpu_torch.models import gemma
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.training import eval as port_eval
    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.config import cli
    from lap_tpu_torch.training.train_step import step_generator

    variants = []
    for base in ("gemma_2b", "gemma_300m"):
        name = f"{base}_depth{TRAIN_PHASE_DEPTH}"
        gemma._VARIANTS[name] = {**gemma._VARIANTS[base], "depth": TRAIN_PHASE_DEPTH}
        variants.append(name)
    log(f"train entry points: parameters in {TRAIN_PHASE_DTYPE}, --freeze_vlm {TRAIN_PHASE_FREEZE_VLM}, depth "
        f"{TRAIN_PHASE_DEPTH}: a run may write 45 GiB to the host's disk, phase 9 writes 6.7 GB and phase 14 "
        f"9.6 GB, and two step directories with every parameter trained would be 2 x 33.5 GB in bfloat16 "
        f"(2 x 67 GB in float32) at full depth")
    # In the checkout, not TMPDIR (which may be memory): tens of GB.
    run_dir = Path(tempfile.mkdtemp(prefix=".train_phase_", dir=REPO))
    numbers = {"dtype": TRAIN_PHASE_DTYPE, "freeze_vlm": TRAIN_PHASE_FREEZE_VLM}
    launches = dict(fwd=0, dq=0, dkv=0, delta=0, group_sum=0, int8=0)
    try:
        config_args = ["lap", "--exp_name", "smoke", "--checkpoint_base_dir", str(run_dir), "--data.repo_id", "fake",
                       "--data.data_mix", "none", "--batch_size", str(TRAIN_BATCH), "--param_dtype",
                       TRAIN_PHASE_DTYPE, "--freeze_vlm", TRAIN_PHASE_FREEZE_VLM, "--save_interval", "1000",
                       "--model.paligemma_variant", variants[0], "--model.action_expert_variant", variants[1]]

        def args(*extra):
            return [*config_args, "--device", str(device), *extra]

        def count(before, what):
            got = tuple(a - b for a, b in zip(flash_and_backward_launches(), before, strict=True))
            for key, n in zip(("fwd", "dq", "dkv", "delta", "group_sum"), got, strict=True):
                launches[key] += n
            log(f"train entry points: {what}: launches (fwd, dq, dkv, delta, group_sum) {got}")
            return got

        free_before = shutil.disk_usage(run_dir).free

        # Run 1: TRAIN_PHASE_STEPS steps from the seed, a save at the last.
        reset_launch_counters()
        t0 = time.monotonic()
        first = port_train.main(args("--num_train_steps", str(TRAIN_PHASE_STEPS)))
        run1_s = time.monotonic() - t0
        got = count((0,) * 5, f"run 1 ({TRAIN_PHASE_STEPS} steps)")
        depth = len(first.trainer.model.llm.layers)
        per_step = (2 * depth, depth, depth, depth, depth)  # as phase 11: remat runs each forward twice; GQA
        if got != tuple(TRAIN_PHASE_STEPS * n for n in per_step):
            raise AssertionError(f"run 1: expected {TRAIN_PHASE_STEPS} x {per_step} launches, got {got}")
        state = first.trainer.state
        saved = state_checksums(state)
        cursor = first.loader.state_dict()
        numbers["write_s"] = first.checkpoints.last_save["seconds"]
        numbers["write_bytes"] = first.checkpoints.last_save["bytes"]
        # Asynchronous save: the loop waits for the copy to host memory
        # (blocked_s); the run waits for the write before it returns.
        numbers["save_blocked_s"] = first.checkpoints.last_save["blocked_s"]
        numbers["save_wait_s"] = first.timings["save_wait_s"]
        free_after_one = shutil.disk_usage(run_dir).free
        # The loss the next batch gives on the in-memory state, with the next
        # step's randomness: the first step of a resumed run must give it.
        batch = next(first.data_iter)
        before = flash_and_backward_launches()
        loss, _ = first.trainer.model.compute_loss(
            *batch, train=True, generator=step_generator(first.trainer.config.seed, state.step, device))
        next_loss = loss.item()
        count(before, "next batch's loss on run 1's state")
        log(f"train entry points: run 1 took {run1_s:.1f} s; saved step {state.step} asynchronously "
            f"({numbers['write_bytes']} bytes written in {numbers['write_s']:.2f} s; save() blocked the loop "
            f"{numbers['save_blocked_s']:.2f} s, wait_until_finished {numbers['save_wait_s']:.2f} s); "
            f"{len(saved) - 2} state tensors "
            f"checksummed; loader cursor {cursor}; next batch's loss {next_loss!r}")
        first.close()
        del first, state, batch, loss
        release()

        # Run 2: resume; no step to take. The restored state against run 1's.
        reset_launch_counters()
        second = port_train.main(args("--num_train_steps", str(TRAIN_PHASE_STEPS), "--resume", "true"))
        restored = state_checksums(second.trainer.state)
        numbers["restore_s"] = second.timings["restore_s"]
        differ = sorted(k for k in saved if restored.get(k) != saved[k])
        if differ or second.loader.state_dict() != cursor:
            raise AssertionError(f"restored state differs from the saved one in {len(differ)} entries "
                                 f"(first {differ[:3]}), cursor {second.loader.state_dict()} vs {cursor}")
        log(f"train entry points: run 2 restored step {second.trainer.state.step} in {numbers['restore_s']:.2f} s: "
            f"all {len(saved) - 2} state tensors bit-equal to run 1's, and the loader cursor")
        second.close()
        del second
        release()

        # Run 3: resume, one step (its loss against run 1's next loss), one
        # validation step, and a save.
        reset_launch_counters()
        third = port_train.main(args("--num_train_steps", str(TRAIN_PHASE_STEPS + 1), "--resume", "true",
                                     "--use_validation", "true", "--val_interval", "1"))
        got = count((0,) * 5, "run 3 (one step and one validation step)")
        if got != tuple(n + (depth if i == 0 else 0) for i, n in enumerate(per_step)):
            raise AssertionError(f"run 3: expected {per_step} + {depth} validation forwards, got {got}")
        resumed_loss = third.metrics["loss"]
        numbers["restore_s_again"] = third.timings["restore_s"]
        numbers["write_s_again"] = third.checkpoints.last_save["seconds"]
        log(f"train entry points: run 3 first loss {resumed_loss!r} vs run 1's next batch {next_loss!r}; "
            f"saved step {third.trainer.state.step} ({third.checkpoints.last_save['bytes']} bytes in "
            f"{numbers['write_s_again']:.2f} s)")
        if resumed_loss != next_loss:
            raise AssertionError("the resumed run's first loss differs from the uninterrupted run's")
        step_dir = third.checkpoints.step_dir(third.trainer.state.step)
        third.close()
        del third
        release()
        free_after = shutil.disk_usage(run_dir).free

        # Offline eval over the last step: one batch, val_loss and action_prediction_l2.
        reset_launch_counters()
        t0 = time.monotonic()
        results = port_eval.main(args("--num_eval_batches", "1", "--eval_all_checkpoints", "false"))
        numbers["eval_s"] = time.monotonic() - t0
        got = count((0,) * 5, "eval (one batch)")
        (step, by_set), = results.items()
        metrics = by_set["original"]
        log(f"train entry points: eval of step {step} in {numbers['eval_s']:.1f} s: "
            f"val_loss={metrics.get('val_loss')!r} action_prediction_l2={metrics.get('action_prediction_l2')!r}")
        if not all(math.isfinite(metrics.get(k, math.nan)) for k in ("val_loss", "action_prediction_l2")):
            raise AssertionError(f"eval metrics missing or not finite: {metrics}")
        if got != (2 * depth, 0, 0, 0, 0):
            raise AssertionError(f"eval: expected {depth} flash launches for the loss and {depth} for "
                                 f"sample_actions, no backward, got {got}")
        release()

        # Serving the trained step directory, bf16 then int8.
        train_config = cli(config_args)
        for quantize in (None, "int8"):
            reset_launch_counters()
            t0 = time.monotonic()
            policy = policy_config.create_trained_policy(train_config, step_dir, allow_test_vocab=True,
                                                         quantize=quantize, device=device)
            restore_s = time.monotonic() - t0
            reset_launch_counters()
            out = policy.infer(raw_request(40, train_config.model))
            flash, int8, _ = serving_launches()
            launches["fwd"] += flash
            launches["int8"] += int8
            actions = np.asarray(out["actions"])
            log(f"train entry points: served step {step} ({quantize or 'bf16'}) restored in {restore_s:.2f} s: "
                f"actions {actions.shape}, {flash} flash and {int8} int8 launches")
            want_int8 = 0 if quantize is None else 2 * depth * 10
            if actions.shape != (train_config.model.action_horizon, train_config.model.action_dim) or not \
                    np.isfinite(actions).all() or flash != depth or int8 != want_int8:
                raise AssertionError(f"serving the trained checkpoint ({quantize}): shape {actions.shape}, "
                                     f"{flash} flash (want {depth}), {int8} int8 (want {want_int8})")
            del policy
            release()
        numbers.update(free_before_gb=free_before / 1e9, free_after_run1_gb=free_after_one / 1e9,
                       free_after_gb=free_after / 1e9, resumed_loss=resumed_loss)
        log(f"train entry points: free disk {free_before / 1e9:.2f} GB before, {free_after_one / 1e9:.2f} GB after "
            f"run 1, {free_after / 1e9:.2f} GB after run 3 (one step kept)")
        print(json.dumps({"train_entry_points": numbers}), flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 14: LAPGemma3-4B (lap_gemma3_4b) at full width
# ---------------------------------------------------------------------------


def g3_request(seed: int, config) -> dict:
    """One model-ready request of phase 14: uint8 cameras, state, the
    synthetic Gemma3 prompt (``g3_prompt``) in 800 slots."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = config.image_resolution
    tokens, valid = g3_prompt(seed)
    return {
        "image": {k: rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for k in config.image_keys},
        "image_mask": {k: np.bool_(True) for k in config.image_keys},
        "state": rng.standard_normal(config.action_dim).astype(np.float32),
        "tokenized_prompt": tokens,
        "tokenized_prompt_mask": np.arange(G3_PROMPT_LEN) < valid,
    }


def quantized_calls(model, experts) -> int:
    """Dequant matmuls one call of ``experts``' layers makes at decode size:
    the weights of those experts that carry quantized copies."""
    calls = 0
    for block in model.llm.layers:
        for i in experts:
            mods = [block.mlp[i], block.attn.attn_vec_einsum[i]]
            mods += [block.attn.qkv_einsum[i]] if block.attn.fused_qkv else [block.attn.q_einsum[i],
                                                                               block.attn.kv_einsum[i]]
            for m in mods:
                calls += sum(m.quantized(prefix) is not None for prefix, *_ in m.quant_targets())
    return calls


def check_g3_masks(seen, cases, what: str) -> dict:
    """``check_case_masks`` for phase 14's paths."""
    return check_case_masks(seen, cases, f"gemma3 {what}")


def run_gemma3_serving(device) -> dict:
    """Phase 14, serving: the full-width lap_gemma3_4b policy in bf16 from
    seeded random weights: flow requests (bf16, then int8 and int4 copies),
    flash against einsum actions, AR requests in bf16, int8 and int4 with the
    teacher-forced kernel check, and the serving stack (a checkpoint
    directory restored through ``serve_policy.create_policy`` and a raw
    request through ``Gemma3Tokenizer``). Returns launch totals and numbers."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import ARPolicy, Policy, _stack_batch
    from lap_tpu_torch.serving import serve_policy
    from lap_tpu_torch.training import checkpoints
    from lap_tpu_torch.training.config import get_config

    train_config = get_config(G3_CONFIG)
    config = dataclasses.replace(train_config.model, stop_action_to_vlm_grad=False)
    t0 = time.monotonic()
    model = config.create_module(device=device, init_seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    depth = len(model.llm.layers)
    n_global = sum(model.llm.is_global)
    numbers = {"params": n_params, "depth": depth}
    log(f"gemma3: built LAPGemma3-4B ({type(model).__name__}, {n_params} params, bf16, {depth} layers of which "
        f"{n_global} global) in {time.monotonic() - t0:.1f} s")
    launches = {"flash": 0, "int8": 0, "int4": 0}
    cases = {name: m for name, _, m in kernel_cases(device) if name.startswith("gemma3_")}
    prefill = g3_prefill_masks(device)
    flow_cases = {n: cases[n] for n in (G3_FLOW_LOCAL, G3_FLOW_GLOBAL)}
    ar_cases = {n: cases[n] for n in (G3_AR_LOCAL, G3_AR_GLOBAL)}
    valid = torch.arange(G3_PROMPT_LEN, device=device)[None] < G3_VALID
    flow_dead = int((~prefill[G3_FLOW_LOCAL].any(-1) & valid).sum())
    ar_dead = int((~prefill[G3_AR_LOCAL].any(-1) & prefill["ar_valid_rows"]).sum())
    numbers.update(flow_dead_valid_rows=flow_dead, ar_dead_valid_rows_per_local_layer=ar_dead)
    log(f"gemma3: the request's prompt holds {G3_VALID} valid tokens of {G3_PROMPT_LEN}; valid rows with no key on "
        f"a local layer: flow prefill {flow_dead}, AR prefill {ar_dead} (right-aligned: the sliding window compares "
        f"positions with cache slots)")
    if flow_dead:
        raise AssertionError("the flow request has dead valid rows: flash and einsum would differ there")

    # Flow serving, bf16.
    policy = Policy(model, num_steps=10, seed=0)
    requests = [g3_request(i, config) for i in range(N_REQUESTS)]
    policy.infer(requests[0])
    reset_launch_counters()
    latencies, per_request = [], []
    with flash_masks() as seen:
        for req in requests:
            before = serving_launches()
            out = policy.infer(req)
            per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            latencies.append(out["policy_timing"]["infer_ms"])
            if out["actions"].shape != (config.action_horizon, config.action_dim) or not np.isfinite(
                    out["actions"]).all():
                raise AssertionError(f"gemma3 flow: bad actions {out['actions'].shape}")
    launches["flash"] += serving_launches()[0]
    if any(c != (depth, 0, 0) for c in per_request):
        raise AssertionError(f"gemma3 flow: expected {depth} flash and no dequant launches a request, got {per_request}")
    counts = check_g3_masks(seen, flow_cases, "flow prefill")
    if counts[G3_FLOW_GLOBAL] != n_global * N_REQUESTS:
        raise AssertionError(f"gemma3 flow: {counts} masks, expected {n_global} global layers a request")
    del seen
    numbers["flow_p50_ms"], numbers["flow_p90_ms"] = percentiles(latencies)
    log(f"gemma3 flow: {len(requests)} requests at batch 1, {depth} flash launches each; infer "
        f"p50_ms={numbers['flow_p50_ms']:.3f} p90_ms={numbers['flow_p90_ms']:.3f} "
        f"chunk_rate_hz={1000.0 / numbers['flow_p50_ms']:.3f} all_ms={[round(x, 3) for x in latencies]} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # Flash against einsum attention on one request, same noise.
    obs = CoTObservation.from_dict(_stack_batch([requests[0]]), device=device)
    noise = torch.randn((1, config.action_horizon, config.action_dim),
                        generator=torch.Generator(device=device).manual_seed(5), device=device)
    a_flash = model.sample_actions(obs, noise=noise)
    model.set_attn_impl("xla")
    a_xla = model.sample_actions(obs, noise=noise)
    model.set_attn_impl(config.attn_impl)
    rel = ((a_flash - a_xla).norm() / a_xla.norm()).item()
    numbers["flow_flash_vs_xla_rel"] = rel
    log(f"gemma3 path: flash vs xla attention actions rel_err={rel:.3e} (tol {PATH_REL_TOL}; {flow_dead} dead valid "
        f"rows) |actions|_max={a_xla.abs().max().item():.3e}")
    if not (torch.isfinite(a_flash).all() and rel <= PATH_REL_TOL):
        raise AssertionError(f"gemma3: flash vs xla actions differ: rel {rel}")
    profile_one_request(policy, requests[0], what="gemma3 flow request")

    # Quantized flow: the action expert's weights that carry copies, at 16
    # rows an Euler step; the 800-row prefill keeps the exact product.
    for mode in ("int8", "int4"):
        model.quantize_(mode)
        expected_flow = quantized_calls(model, experts=(1,)) * 10
        policy = Policy(model, num_steps=10, seed=0)
        policy.infer(requests[0])
        reset_launch_counters()
        lat, per = [], []
        for req in requests[:G3_QUANT_FLOW_REQUESTS]:
            before = serving_launches()
            out = policy.infer(req)
            per.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            lat.append(out["policy_timing"]["infer_ms"])
        want = (depth, expected_flow if mode == "int8" else 0, expected_flow if mode == "int4" else 0)
        if any(c != want for c in per):
            raise AssertionError(f"gemma3 {mode} flow: expected {want} (flash, int8, int4) launches, got {per}")
        for key, n in zip(("flash", "int8", "int4"), serving_launches()):
            launches[key] += n
        got = model.sample_actions(obs, noise=noise)
        numbers[f"flow_{mode}_p50_ms"] = percentiles(lat)[0]
        log(f"gemma3 quant flow {mode}: (flash, int8, int4) launches per request {want}; infer "
            f"p50_ms={numbers[f'flow_{mode}_p50_ms']:.3f} all_ms={[round(x, 3) for x in lat]}; actions vs bf16 "
            f"rel_err={((got - a_flash).norm() / a_flash.norm()).item():.3e} (information)")
    model.quantize_(None)

    # AR serving, AR_STEPS tokens, bf16 / int8 / int4.
    vocab = model.llm.embedder.input_embedding.shape[0]
    ar_requests = [g3_request(300 + i, config) for i in range(G3_AR_REQUESTS)]
    ar_obs = CoTObservation.from_dict(_stack_batch([ar_requests[0]]), device=device)
    for mode in ("bf16", "int8", "int4"):
        model.quantize_(None if mode == "bf16" else mode)
        per_token = quantized_calls(model, experts=(0,)) + (model.llm.embedder.quantized("decode_") is not None)
        per_quant = per_token * AR_STEPS + (per_token > 0)
        policy = ARPolicy(model, max_decoding_steps=AR_STEPS, stop_on_eos=False, seed=0)
        policy.infer(ar_requests[0])
        want = (depth, per_quant if mode == "int8" else 0, per_quant if mode == "int4" else 0)
        reset_launch_counters()
        lat, per = [], []
        with flash_masks() as seen:
            for req in ar_requests:
                before = serving_launches()
                out = policy.infer(req)
                per.append(tuple(a - b for a, b in zip(serving_launches(), before)))
                lat.append(out["policy_timing"]["infer_ms"])
                tokens = out["tokens"]
                if tokens.shape != (1, AR_STEPS) or not ((tokens >= 0) & (tokens < vocab)).all():
                    raise AssertionError(f"gemma3 {mode} AR: bad tokens {tokens.shape}")
        if any(c != want for c in per):
            raise AssertionError(f"gemma3 {mode} AR: expected {want} (flash, int8, int4) launches, got {per}")
        check_g3_masks(seen, ar_cases, f"AR {mode} prefill")
        del seen
        for key, n in zip(("flash", "int8", "int4"), serving_launches()):
            launches[key] += n
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.ar_prefill(ar_obs, AR_STEPS)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t0) * 1e3)
        p50 = percentiles(lat)[0]
        numbers[f"ar_{mode}"] = dict(p50_ms=p50, ms_per_token=p50 / AR_STEPS, prefill_ms=statistics.median(prefill_ms),
                                     dequant_per_token=per_token if mode != "bf16" else 0)
        log(f"gemma3 AR {mode}: {AR_STEPS} tokens at batch 1, (flash, int8, int4) launches per request {want} "
            f"({per_token} dequant calls a token when quantized) over {len(ar_requests)} requests; infer "
            f"p50_ms={p50:.3f} ms_per_token={p50 / AR_STEPS:.3f} prefill_ms={statistics.median(prefill_ms):.3f} "
            f"all_ms={[round(x, 3) for x in lat]} tokens[0][:8]={tokens[0, :8].tolist()}")
        # The profile of a request of AR_PROFILE_STEPS tokens (a 64-token
        # trace of ~290,000 kernels takes the profiler about a minute), with
        # one dequant kernel per dequant call, as phase 8 holds it.
        short = ARPolicy(model, max_decoding_steps=AR_PROFILE_STEPS, stop_on_eos=False, seed=0)
        short_calls = per_token * AR_PROFILE_STEPS + (per_token > 0)
        profiled = profile_one_request(short, ar_requests[0], tokens=AR_PROFILE_STEPS, pad_s=PROFILE_COUNT_PAD_S,
                                       what=f"gemma3 AR request ({mode}, {AR_PROFILE_STEPS} tokens)")
        log(f"profile: gemma3 AR {mode}, {AR_PROFILE_STEPS} tokens: dequant kernels in the profile {profiled} for "
            f"{short_calls} dequant calls")
        if not PROFILE_KEPT_SHARE * short_calls <= profiled <= short_calls:
            raise AssertionError(f"gemma3 {mode} AR: the profile holds {profiled} dequant kernels for {short_calls} "
                                 f"dequant calls")
    model.quantize_(None)
    check_ar_kernels_against_plain(model, config, device, request=g3_request(400, config))

    # The serving stack: a checkpoint directory from this model, restored by
    # serve_policy.create_policy (--env LAP --config lap_gemma3_4b), and a raw
    # request through Gemma3Tokenizer with the test vocabulary.
    with tempfile.TemporaryDirectory(prefix="lap_g3_ckpt_") as ckpt:
        ckpt_dir = Path(ckpt)
        t0 = time.monotonic()
        path = checkpoints.save_params(model, ckpt_dir / "params")
        checkpoints.save_norm_stats(ckpt_dir / "assets" / train_config.data.asset_id / "norm_stats.json",
                                    serving_norm_stats(config.action_dim))
        numbers["write_s"], numbers["write_bytes"] = time.monotonic() - t0, path.stat().st_size
        t0 = time.monotonic()
        served = serve_policy.create_policy(serve_policy.parse_args([
            "--env", "LAP", "--config", G3_CONFIG, "--checkpoint_dir", str(ckpt_dir), "--allow_test_vocab",
            "--default_prompt", DEFAULT_PROMPT, "--device", str(device)]))
        torch.cuda.synchronize()
        numbers["restore_s"] = time.monotonic() - t0
        raw = raw_request(900, config)
        served.infer(raw)
        reset_launch_counters()
        np.random.seed(15)  # the lap data config's wrist dropout draws from numpy's global RNG
        out = served.infer(raw)
        raw_launches = serving_launches()
        launches["flash"] += raw_launches[0]
        prepared = served._prepare(raw)
        n_tokens = int(prepared["tokenized_prompt_mask"].sum())
        n_images = int((prepared["tokenized_prompt"] == model.IMAGE_TOKEN).sum())
        actions = np.asarray(out["actions"])
        obs_raw = CoTObservation.from_dict(_stack_batch([prepared]), device=device)
        noise_raw = torch.randn((1, config.action_horizon, config.action_dim),
                                generator=torch.Generator(device=device).manual_seed(16), device=device)
        restored = served._model.sample_actions(obs_raw, noise=noise_raw)
        in_memory = model.sample_actions(obs_raw, noise=noise_raw)
        log(f"gemma3 serving stack: wrote {numbers['write_bytes']} bytes in {numbers['write_s']:.2f} s, "
            f"create_policy restored it in {numbers['restore_s']:.2f} s; one raw request through Gemma3Tokenizer "
            f"(test vocabulary): {n_tokens} valid prompt tokens with {n_images} placeholders, actions "
            f"{actions.shape} in physical units, (flash, int8, int4) launches {raw_launches}, infer_ms="
            f"{out['policy_timing']['infer_ms']:.3f}; restored vs in-memory model at the same noise: "
            f"{'bit-equal' if torch.equal(restored, in_memory) else 'DIFFERENT'}")
        if actions.shape != (config.action_horizon, config.action_dim) or not np.isfinite(actions).all() \
                or raw_launches != (depth, 0, 0) or n_images != 2 * 256:
            raise AssertionError(f"gemma3 serving stack: bad raw request ({actions.shape}, {raw_launches}, {n_images})")
        if not torch.equal(restored, in_memory):
            raise AssertionError("gemma3 serving stack: the restored model's actions differ from the in-memory model's")
        del served, restored, in_memory
    del model, policy
    release()
    numbers["launches"] = launches
    return numbers


def run_gemma3_training(device) -> dict:
    """Phase 14, training: the lap_gemma3_4b trainer at full width with both
    experts cut to ``G3_TRAIN_DEPTH`` layers (float32 parameters, AdamW, EMA),
    batch TRAIN_BATCH of the synthetic batch (the image blocks in the
    prompt), per-step launch counts, a falling loss, peak memory, one
    profiled step."""
    import dataclasses

    import torch

    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.config import get_config
    from lap_tpu_torch.training.optimizer import CosineDecaySchedule

    base = get_config(G3_CONFIG)
    names = []
    for variant in (base.model.paligemma_variant, base.model.action_expert_variant):
        name = f"{variant}_depth{G3_TRAIN_DEPTH}"
        w, h, n, k, hd, _, window = gemma3._VARIANTS[variant]
        gemma3._VARIANTS[name] = (w, h, n, k, hd, G3_TRAIN_DEPTH, window)
        names.append(name)
    sched = base.lr_schedule
    config = dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, paligemma_variant=names[0], action_expert_variant=names[1]),
        lr_schedule=CosineDecaySchedule(warmup_steps=G3_TRAIN_STEPS + 3, peak_lr=sched.peak_lr,
                                        decay_steps=sched.decay_steps, decay_lr=sched.decay_lr),
    )
    t0 = time.monotonic()
    trainer = port_train.build_trainer(config, device=device)
    batch = port_train.fake_train_batch(config.model, TRAIN_BATCH, device=device, seed=config.seed)
    trainer.run(batch, 1)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"gemma3 training: built the lap_gemma3_4b trainer at depth {G3_TRAIN_DEPTH} ({n_params} params in "
        f"{config.param_dtype}, EMA {'on' if trainer.state.ema_params is not None else 'off'}, batch {TRAIN_BATCH}) "
        f"and took the first step in {time.monotonic() - t0:.1f} s")
    depth = len(trainer.model.llm.layers)
    n_global = sum(trainer.model.llm.is_global)
    masks = {"local": g3_training_mask(TRAIN_BATCH, device), "global": g3_training_mask(TRAIN_BATCH, device,
                                                                                         is_global=True)}
    # The loss at fixed flow noise and time, before and after the steps (each
    # step draws its own, which moves the action loss from step to step).
    gen = torch.Generator(device=device).manual_seed(19)
    noise = torch.randn((TRAIN_BATCH, config.model.action_horizon, config.model.action_dim), generator=gen,
                        device=device)
    time_ = torch.rand((TRAIN_BATCH,), generator=gen, device=device) * 0.999 + 0.001

    def fixed_loss() -> float:
        with torch.no_grad():
            return trainer.model.compute_loss(*batch, train=False, noise=noise, time=time_)[0].item()

    before_loss = fixed_loss()
    reset_launch_counters()
    torch.cuda.reset_peak_memory_stats()
    records, per_step = [], []
    with flash_masks() as seen:
        for _ in range(G3_TRAIN_STEPS):
            before = flash_and_backward_launches()
            records += trainer.run(batch, 1)
            per_step.append(tuple(a - b for a, b in zip(flash_and_backward_launches(), before)))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_launches = dict(zip(("fwd", "dq", "dkv", "delta", "group_sum"), flash_and_backward_launches()))
    counts = check_g3_masks(seen, masks, "training step")
    del seen
    expected = (2 * depth, depth, depth, depth, depth)  # remat runs each forward twice; GQA group 2
    log(f"gemma3 training: launches per step (fwd, dq, dkv, delta, group_sum) {per_step}")
    if any(c != expected for c in per_step) or counts["global"] != 2 * n_global * G3_TRAIN_STEPS:
        raise AssertionError(f"gemma3 training: expected {expected} launches a step and {2 * n_global} global masks, "
                             f"got {per_step}, {counts}")
    losses = [r["loss"] for r in records]
    after_loss = fixed_loss()
    log(f"gemma3 training: the loss at fixed noise and time {before_loss:.6f} before the {G3_TRAIN_STEPS} steps, "
        f"{after_loss:.6f} after")
    if not all(math.isfinite(x) for x in losses) or not after_loss < before_loss:
        raise AssertionError(f"gemma3 training: the loss did not fall or is not finite: {losses}, "
                             f"{before_loss} -> {after_loss}")
    step_ms = [r["step_ms"] for r in records]
    numbers = dict(depth=depth, params=n_params, step_ms_median=statistics.median(step_ms), peak_gib=peak_gib,
                   losses=losses, fixed_loss=(before_loss, after_loss), launches=step_launches)
    full = sum(p.numel() for p in base.model.create_module(device="meta", init_seed=None).parameters())
    numbers["full_depth_params"] = full
    log(f"gemma3 training: {G3_TRAIN_STEPS} steps at batch {TRAIN_BATCH} loss={[round(x, 4) for x in losses]} "
        f"grad_norm={[round(r['grad_norm'], 4) for r in records]} step_ms_median={numbers['step_ms_median']:.3f} "
        f"step_ms={[round(x, 1) for x in step_ms]} samples_per_s={TRAIN_BATCH * 1000.0 / numbers['step_ms_median']:.3f} "
        f"peak_mem_gib={peak_gib:.2f}; at full depth ({base.model.backbone_depth} layers) the model has {full} "
        f"params: f32 parameters, gradient, Adam moments and EMA take 20 B each, {20 * full / 1e9:.1f} GB")
    profile_one_step(trainer, batch)
    del trainer, batch
    release()
    return numbers


def check_small_gemma3_reference(device) -> None:
    """The gemma3_dummy LAPGemma3 in f32 on the card against the same weights
    on the CPU (the path the CPU tests hold against the JAX package):
    ``sample_actions`` within SMALL_REF_TOL, AR tokens exactly."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.lap_gemma3 import image_prompt_head
    from lap_tpu_torch.models.lap_model import LAPConfig
    from lap_tpu_torch.models.types import CoTObservation

    config = LAPConfig(
        dtype="float32", paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy",
        siglip_variant="dummy", action_horizon=4, max_token_len=64, image_resolution=(56, 56),
        enable_action_training=True,
    )
    cpu = config.create_module(device="cpu", init_seed=0)
    with torch.no_grad():
        cpu.llm.embedder.input_embedding.mul_(100.0)  # no near-tied logits
    gpu = config.create_module(device=device, init_seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(17)
    head = image_prompt_head(config)
    tokens = rng.integers(300, 2000, (2, 64)).astype(np.int32)
    tokens[:, : len(head)] = head
    valid = np.array([[60], [50]])
    batch = {
        "image": {k: rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8) for k in config.image_keys},
        "state": rng.standard_normal((2, 7)).astype(np.float32),
        "tokenized_prompt": np.where(np.arange(64)[None] < valid, tokens, 0).astype(np.int32),
        "tokenized_prompt_mask": np.arange(64)[None, :] < valid,
    }
    noise = torch.from_numpy(rng.standard_normal((2, 4, 7)).astype(np.float32))
    ref = cpu.sample_actions(CoTObservation.from_dict(batch, device="cpu"), noise=noise)
    got = gpu.sample_actions(CoTObservation.from_dict(batch, device=device), noise=noise)
    err = (got.cpu() - ref).abs().max().item()
    kw = dict(max_decoding_steps=SMALL_AR_STEPS, stop_on_eos=False)
    ref_tokens = cpu.sample_tokens(CoTObservation.from_dict(batch, device="cpu"), **kw)
    got_tokens = gpu.sample_tokens(CoTObservation.from_dict(batch, device=device), **kw).cpu()
    log(f"small reference: dummy LAPGemma3 f32 card vs CPU actions max_abs_err={err:.3e} (tol {SMALL_REF_TOL}), "
        f"AR tokens equal={torch.equal(got_tokens, ref_tokens)}: {got_tokens.tolist()}")
    if not (err <= SMALL_REF_TOL and torch.equal(got_tokens, ref_tokens)):
        raise AssertionError("card and CPU disagree on the dummy LAPGemma3")


# ---------------------------------------------------------------------------
# Phase 15: the rest of the model surface at full width (FAST, pi0, the
# VLM-only vla0 model, LoRA training)
# ---------------------------------------------------------------------------


def _seed_host(seed: int = VARIANT_HOST_SEED) -> None:
    """The host transforms draw from numpy's and Python's global RNGs (the
    data configs' wrist dropout): the same seed before every raw request, and
    before the phase-2 cases are built from it, gives the same inputs."""
    import random

    import numpy as np

    np.random.seed(seed)
    random.seed(seed)


def variant_raw_request(seed: int, config) -> dict:
    """A raw robot request of phase 15: ``raw_request``'s cameras, with a
    fixed instruction and state (discretised into the prompt), so that every
    request of a config tokenizes to the same prompt."""
    import numpy as np

    request = raw_request(seed, config, prompt=SERVING_PROMPTS[0])
    request["observation"]["state"] = np.linspace(-0.5, 0.5, config.action_dim).astype(np.float32)
    return request


@functools.lru_cache(maxsize=None)
def variant_prepared(config_name: str, ar: bool):
    """The request of ``config_name`` after its policy's input stack (a dict
    of numpy arrays), as ``Policy.infer`` prepares it."""
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.model_transforms import compose
    from lap_tpu_torch.training.config import get_config

    train_config = get_config(config_name)
    stats = serving_norm_stats(train_config.model.action_dim)
    inputs, _ = policy_config._build_transform_stacks(train_config, stats, ar=ar)
    _seed_host()
    return compose(inputs)(dict(variant_raw_request(500, train_config.model)))


def prefix_attention_mask(prepared: dict, device, *, tokens_per_camera: int = 256):
    """The prefix's (input mask, attention mask) as ``LAP.embed_prefix`` and
    ``make_attn_mask`` build them for this prepared request: the cameras'
    tokens bidirectional, the prompt's language-action tokens causal."""
    import numpy as np
    import torch

    from lap_tpu_torch.ops.masks import make_attn_mask

    cams = [np.full(tokens_per_camera, bool(prepared["image_mask"][k])) for k in prepared["image"]]
    prompt = np.asarray(prepared["tokenized_prompt_mask"], bool)
    langact = prepared.get("tokenized_langact_mask")
    langact = np.zeros_like(prompt) if langact is None else np.asarray(langact, bool)
    input_mask = torch.from_numpy(np.concatenate([*cams, prompt]))[None].to(device)
    ar = torch.from_numpy(np.concatenate([np.zeros(len(cams) * tokens_per_camera, bool), langact]))[None].to(device)
    return input_mask, make_attn_mask(input_mask, ar)


def right_aligned(prepared: dict, decode_slots: int, device):
    """The AR prefill's mask: the prefix right-aligned and padded with
    ``decode_slots`` masked key columns, as ``LAP.ar_prefill`` passes it."""
    import torch

    from lap_tpu_torch.models.lap_model import left_to_right_align

    input_mask, attn = prefix_attention_mask(prepared, device)
    x = torch.zeros((1, input_mask.shape[1], 1), device=device)
    _, _, aligned = left_to_right_align(x, input_mask, attn)
    return torch.nn.functional.pad(aligned, (0, decode_slots)).contiguous()


def variant_kernel_cases(device) -> list:
    """Phase 15's flash-forward cases: the masks of the requests it serves
    (built from the same prepared requests)."""
    fast, pi0 = variant_prepared(FAST_CONFIG, False), variant_prepared(PI0_CONFIG, False)
    vla0 = variant_prepared(VLA0_CONFIG, True)
    out = []
    for name, mask in (
        (FAST_FLOW_CASE, prefix_attention_mask(fast, device)[1].contiguous()),
        (FAST_AR_CASE, right_aligned(variant_prepared(FAST_CONFIG, True), AR_STEPS, device)),
        (PI0_FLOW_CASE, prefix_attention_mask(pi0, device)[1].contiguous()),
        (VLA0_AR_CASE, right_aligned(vla0, AR_STEPS, device)),
        (VLA0_FORCED_CASE, right_aligned(vla0, AR_FORCED_STEPS, device)),
    ):
        out.append((name, (1, mask.shape[1], mask.shape[2], 8, 1, 256), mask))
    return out


def lora_train_config():
    """The LoRA training phase's config: ``lap`` with both experts' LoRA
    variants, the fake loader, batch TRAIN_BATCH, the config's float32
    parameters and EMA, the warm-up cut to the run (as phase 11's)."""
    import dataclasses

    from lap_tpu_torch.training.config import cli
    from lap_tpu_torch.training.optimizer import CosineDecaySchedule

    config = cli(["lap", "--model.paligemma_variant", "gemma_2b_lora", "--model.action_expert_variant",
                  "gemma_300m_lora", "--data.repo_id", "fake", "--data.data_mix", "none", "--batch_size",
                  str(TRAIN_BATCH), "--exp_name", "lora"])
    sched = config.lr_schedule
    return dataclasses.replace(config, lr_schedule=CosineDecaySchedule(
        warmup_steps=LORA_TRAIN_STEPS + 2, peak_lr=sched.peak_lr, decay_steps=sched.decay_steps,
        decay_lr=sched.decay_lr))


@functools.lru_cache(maxsize=None)
def lora_train_batch(device):
    """The fake loader's first batch of the LoRA config (seed 0) on
    ``device``: the fixed batch the LoRA phase trains on."""
    from lap_tpu_torch.data.loader import create_data_loader

    loader = create_data_loader(lora_train_config(), device=device, split="train")
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def lora_training_mask(device):
    """The mask of the LoRA step's prefix call ([B, 692, 708], the first 692
    rows of the joint mask, as ``compute_loss`` builds it for the fixed
    batch)."""
    import torch

    from lap_tpu_torch.models.lap_model import LAP

    obs, _ = lora_train_batch(device)
    b = obs.tokenized_prompt.shape[0]
    cams = [obs.image_masks[k].to(torch.bool)[:, None].expand(b, 256) for k in obs.images]
    prompt = obs.tokenized_prompt_mask.to(torch.bool)
    langact = obs.tokenized_langact_mask.to(torch.bool)
    prefix = torch.cat([*cams, prompt], dim=1)
    prefix_ar = torch.cat([torch.zeros((b, 256 * len(cams)), dtype=torch.bool, device=device), langact], dim=1)
    action_view = prefix & ~torch.nn.functional.pad(langact, (256 * len(cams), 0))
    suffix = torch.ones((b, ACTION_HORIZON), dtype=torch.bool, device=device)
    suffix_ar = torch.zeros_like(suffix)
    suffix_ar[:, 0] = True
    # Neither method reads the model: called on the class.
    joint = LAP._build_combined_attention_mask(None, prefix, prefix_ar, action_view, suffix, suffix_ar)
    return joint.contiguous()[:, :prefix.shape[1]]


def check_case_masks(seen, cases, what: str) -> dict:
    """Every mask the path gave the flash forward is one of ``cases``
    (name -> mask, batch rows in any order); returns how many of each."""
    import torch

    counts = dict.fromkeys(cases, 0)
    for m in seen:
        name = next((n for n, c in cases.items()
                     if m.shape == c.shape and (torch.equal(m, c) or torch.equal(m, c.flip(0)))), None)
        if name is None:
            raise AssertionError(f"{what}: a flash mask {tuple(m.shape)} is none of its kernel cases {list(cases)}")
        counts[name] += 1
    log(f"{what}: the {len(seen)} masks the flash forward was given are its kernel cases' ({counts})")
    return counts


def flow_requests(policy, requests, depth, what: str, cases: dict) -> dict:
    """Serve ``requests`` through ``policy`` (the host seeded before each),
    with ``depth`` flash launches and no dequant launch each, every mask a
    kernel case; returns p50/p90 and the launches."""
    import numpy as np

    _seed_host()
    policy.infer(requests[0])  # first use at these shapes
    reset_launch_counters()
    latencies, per_request = [], []
    with flash_masks() as seen:
        for req in requests:
            before = serving_launches()
            _seed_host()
            out = policy.infer(req)
            per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
            latencies.append(out["policy_timing"]["infer_ms"])
            actions = np.asarray(out["actions"])
            if actions.shape != (ACTION_HORIZON, 7) or not np.isfinite(actions).all():
                raise AssertionError(f"{what}: bad actions {actions.shape}")
    if any(c != (depth, 0, 0) for c in per_request):
        raise AssertionError(f"{what}: expected {depth} flash and no dequant launches a request, got {per_request}")
    check_case_masks(seen, cases, what)
    p50, p90 = percentiles(latencies)
    log(f"{what}: {len(requests)} raw requests at batch 1, {depth} flash launches each; infer p50_ms={p50:.3f} "
        f"p90_ms={p90:.3f} all_ms={[round(x, 3) for x in latencies]}")
    return {"p50_ms": p50, "p90_ms": p90, "launches": {"fwd": serving_launches()[0]}}


def flash_vs_einsum_actions(model, prepared: dict, device, what: str) -> float:
    """Actions of one prepared request with the flash kernels and with einsum
    attention, same noise: their relative L2 distance (<= PATH_REL_TOL)."""
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import _stack_batch

    obs = CoTObservation.from_dict(_stack_batch([prepared]), device=device)
    noise = torch.randn((1, model.config.action_horizon, model.config.action_dim),
                        generator=torch.Generator(device=device).manual_seed(5), device=device)
    with torch.inference_mode():
        a_flash = model.sample_actions(obs, noise=noise)
        model.set_attn_impl("xla")
        a_xla = model.sample_actions(obs, noise=noise)
        model.set_attn_impl(model.config.attn_impl)
    rel = ((a_flash - a_xla).norm() / a_xla.norm()).item()
    log(f"path: {what} flash vs xla attention actions rel_err={rel:.3e} "
        f"max_abs_err={(a_flash - a_xla).abs().max().item():.3e}")
    if not (torch.isfinite(a_flash).all() and rel <= PATH_REL_TOL):
        raise AssertionError(f"{what}: flash vs xla actions rel {rel} > {PATH_REL_TOL}")
    return rel


def carried_model(source, config, device, seed: int):
    """A model of ``config`` whose parameters at the JAX params paths it
    shares with ``source`` (the weight bridge's ``jax_path``, with equal
    shapes) are copied from it on the card, the rest (pi0's projections and
    plain expert-1 norms) seeded random. Returns (model, carried, total)."""
    import torch

    from lap_tpu_torch.models import convert
    from lap_tpu_torch.models.init import random_init_

    model = config.create_module(device=device, init_seed=None)
    own = dict(model.named_parameters())
    by_path = {convert.jax_path(n): p for n, p in source.named_parameters()}
    pairs = [(p, by_path[convert.jax_path(n)]) for n, p in own.items()
             if convert.jax_path(n) in by_path and by_path[convert.jax_path(n)].shape == p.shape]
    if len(pairs) != len(own):
        random_init_(model, seed)
    with torch.no_grad():
        for target, value in pairs:
            target.copy_(value)
    return model, len(pairs), len(own)


def time_fast_tokenize(train_config) -> dict:
    """Host time of ``TokenizeFASTInputs`` (the config's DCT codec) on a
    request with an action chunk (training) and without (serving), and of
    the FAST BPE encode, C++ against Python, on a trained vocabulary; with
    the native host ops' status."""
    import numpy as np

    from lap_tpu_torch import native
    from lap_tpu_torch.models.bpe import IntBPE
    from lap_tpu_torch.models.fast_tokenizer import FASTActionCodec, TokenizeFASTInputs, make_fast_tokenizer

    model = train_config.model
    tok = make_fast_tokenizer(model)
    transform = TokenizeFASTInputs(tok, discrete_state_input=model.discrete_state_input)
    rng = np.random.default_rng(21)
    state = rng.uniform(-1, 1, model.action_dim).astype(np.float32)
    actions = np.tanh(rng.normal(size=(model.action_horizon, model.action_dim))).astype(np.float32)

    def per_call_ms(fn, n=200):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    codec = FASTActionCodec()
    corpus = [codec.quantize(np.tanh(rng.normal(size=actions.shape) * 0.3)) for _ in range(64)]
    bpe = IntBPE.train(corpus, alphabet_size=codec.num_bins, num_merges=128)
    symbols = codec.quantize(actions)
    out = {
        "tokenize_with_actions_ms": per_call_ms(lambda: transform({"prompt": "stack the cups", "state": state,
                                                                  "actions": actions})),
        "tokenize_serving_ms": per_call_ms(lambda: transform({"prompt": "stack the cups", "state": state})),
        "bpe_encode_ms": per_call_ms(lambda: bpe.encode(symbols)),
        "bpe_encode_py_ms": per_call_ms(lambda: bpe.encode_py(symbols)),
        "native": native.status(),
    }
    if bpe.encode(symbols) != bpe.encode_py(symbols):
        raise AssertionError("the native BPE encode differs from the Python one")
    log(f"fast: host TokenizeFASTInputs {out['tokenize_with_actions_ms']:.3f} ms a request with an action chunk, "
        f"{out['tokenize_serving_ms']:.3f} ms without; BPE encode of {len(symbols)} symbols "
        f"{out['bpe_encode_ms']:.4f} ms (C++) vs {out['bpe_encode_py_ms']:.4f} ms (Python); native host ops: "
        f"{out['native']}")
    return out


def run_fast_serving(model, device) -> dict:
    """Phase 15.1: pi05_replicated (FAST action tokens, LAP-3B, prompt 220,
    prefix 732): raw requests through its flow stack (``Policy``) and its AR
    stack (``ARPolicy`` for AR_STEPS tokens, then ``ExtractFASTActions``)."""
    import numpy as np

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.policy import ARPolicy, Policy, _stack_batch
    from lap_tpu_torch.training.config import get_config

    train_config = get_config(FAST_CONFIG)
    stats = serving_norm_stats(7)
    ar_request = variant_raw_request(500, train_config.model)  # the request variant_prepared holds
    depth = len(model.llm.layers)
    cases = {n: m for n, _, m in variant_kernel_cases(device)}
    inputs, outputs = policy_config._build_transform_stacks(train_config, stats, ar=False)
    policy = Policy(model, input_transforms=inputs, output_transforms=outputs, seed=0)
    requests = [variant_raw_request(510 + i, train_config.model) for i in range(VARIANT_REQUESTS)]
    numbers = {"prompt_valid": int(np.sum(variant_prepared(FAST_CONFIG, False)["tokenized_prompt_mask"]))}
    numbers["flow"] = flow_requests(policy, requests, depth, "fast flow", {FAST_FLOW_CASE: cases[FAST_FLOW_CASE]})
    numbers["flow"]["rel_err"] = flash_vs_einsum_actions(model, variant_prepared(FAST_CONFIG, False), device,
                                                         "fast flow")

    inputs, outputs = policy_config._build_transform_stacks(train_config, stats, ar=True)
    ar = ARPolicy(model, input_transforms=inputs, output_transforms=outputs, max_decoding_steps=AR_STEPS,
                  stop_on_eos=False, seed=0)
    _seed_host()
    ar.infer(requests[0])
    reset_launch_counters()
    with flash_masks() as seen:
        _seed_host()
        out = ar.infer(ar_request)
    check_case_masks(seen, {FAST_AR_CASE: cases[FAST_AR_CASE]}, "fast AR")
    actions = np.asarray(out["actions"])
    if actions.shape != (ACTION_HORIZON, 7) or not np.isfinite(actions).all() or serving_launches() != (depth, 0, 0):
        raise AssertionError(f"fast AR: actions {actions.shape}, launches {serving_launches()}")
    # The served actions are ExtractFASTActions of the tokens the model gave.
    obs = CoTObservation.from_dict(_stack_batch([variant_prepared(FAST_CONFIG, True)]), device=device)
    tokens = model.sample_tokens(obs, max_decoding_steps=AR_STEPS, stop_on_eos=False,
                                 generator=None).cpu().numpy()
    extract = outputs[0]
    again = extract({"tokens": tokens})["actions"]
    tok = extract.tokenizer
    vocab = tok._tokenizer.vocab_size()
    lo, hi = vocab - 1 - tok.skip_tokens - (tok.codec.vocab_size - 1), vocab - 1 - tok.skip_tokens
    in_range = int(((tokens >= lo) & (tokens <= hi)).sum())
    if not np.array_equal(again, actions):
        raise AssertionError("fast AR: the served actions are not ExtractFASTActions of the greedy tokens")
    numbers["ar"] = {"infer_ms": out["policy_timing"]["infer_ms"], "tokens": AR_STEPS,
                     "tokens_in_action_range": in_range, "action_range": [lo, hi]}
    numbers["launches"] = {"fwd": numbers["flow"]["launches"]["fwd"] + depth}
    log(f"fast AR: a raw request through the FAST stack, {AR_STEPS} tokens, {depth} flash launches, in "
        f"{out['policy_timing']['infer_ms']:.1f} ms; {in_range} of {AR_STEPS} tokens in the action range [{lo}, {hi}] "
        f"(test vocabulary, random weights), ExtractFASTActions gives {actions.shape} (the rest padded with "
        f"num_bins // 2)")
    numbers["tokenize"] = time_fast_tokenize(train_config)
    return numbers


def run_pi0_serving(base, device) -> dict:
    """Phase 15.2: pi0_replicated with ``--model.pi05 False`` (LAP-3B, prefix
    732): the shared weights carried from the LAP-3B model, flow requests
    through its stack, flash against einsum actions."""
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.policy import Policy
    from lap_tpu_torch.training.config import cli

    train_config = cli([PI0_CONFIG, "--model.pi05", "False"])
    t0 = time.monotonic()
    model, carried, total = carried_model(base, train_config.model, device, seed=1)
    depth = len(model.llm.layers)
    log(f"pi0: built the pi0 model ({sum(p.numel() for p in model.parameters())} params, bf16) in "
        f"{time.monotonic() - t0:.1f} s, {carried} of {total} JAX leaves carried from LAP-3B")
    cases = {n: m for n, _, m in variant_kernel_cases(device)}
    inputs, outputs = policy_config._build_transform_stacks(train_config, serving_norm_stats(7), ar=False)
    policy = Policy(model, input_transforms=inputs, output_transforms=outputs, seed=0)
    requests = [variant_raw_request(520 + i, train_config.model) for i in range(VARIANT_REQUESTS)]
    numbers = flow_requests(policy, requests, depth, "pi0 flow", {PI0_FLOW_CASE: cases[PI0_FLOW_CASE]})
    numbers["rel_err"] = flash_vs_einsum_actions(model, variant_prepared(PI0_CONFIG, False), device, "pi0 flow")
    numbers["carried_leaves"] = [carried, total]
    del model, policy
    release()
    return numbers


def run_vla0_serving(base, device) -> dict:
    """Phase 15.3: vla0_replicated (the VLM-only model: gemma_2b + So400m,
    prompt 390, prefix 902, horizon 10), carried from LAP-3B's image encoder
    and expert 0: a raw request through the vla0 stacks, AR for AR_STEPS
    tokens in bf16, int8 and int4 (launches, p50, prefill), a profiled
    AR_PROFILE_STEPS-token request per mode, and the teacher-forced logits
    with the kernels against the plain versions."""
    import numpy as np
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.policy import ARPolicy, Policy, _stack_batch
    from lap_tpu_torch.training.config import get_config

    train_config = get_config(VLA0_CONFIG)
    t0 = time.monotonic()
    model, carried, total = carried_model(base, train_config.model, device, seed=2)
    if carried != total:
        raise AssertionError(f"vla0: {carried} of {total} leaves carried; the VLM-only tree is LAP-3B's expert 0 "
                             f"and image encoder")
    depth = len(model.llm.layers)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"vla0: built the VLM-only model ({n_params} params, {model.num_experts} expert, bf16) in "
        f"{time.monotonic() - t0:.1f} s, every leaf carried from LAP-3B")
    try:
        Policy(model)
        raise AssertionError("vla0: the flow Policy took a VLM-only model")
    except ValueError as e:
        log(f"vla0: the flow Policy refuses the model: {e}")
    cases = {n: m for n, _, m in variant_kernel_cases(device)}
    stats = serving_norm_stats(7)
    inputs, outputs = policy_config._build_transform_stacks(train_config, stats, ar=True)
    numbers = {"params": n_params, "prompt_valid": int(np.sum(variant_prepared(VLA0_CONFIG, True)[
        "tokenized_prompt_mask"]))}
    requests = [variant_raw_request(530 + i, train_config.model) for i in range(AR_REQUESTS)]
    launches = {"fwd": 0, "int8": 0, "int4": 0}
    obs = CoTObservation.from_dict(_stack_batch([variant_prepared(VLA0_CONFIG, True)]), device=device)
    for mode in ("bf16", "int8", "int4"):
        model.quantize_(None if mode == "bf16" else mode)
        # A step's dequant calls: the quantized weights of the one expert's
        # layers (4 a layer at full width) and the vocab head.
        per_token = quantized_calls(model, [0]) + 1 if mode != "bf16" else 0
        per_quant = per_token * AR_STEPS + 1
        policy = ARPolicy(model, input_transforms=inputs, output_transforms=outputs, max_decoding_steps=AR_STEPS,
                          stop_on_eos=False, seed=0)
        _seed_host()
        policy.infer(requests[0])
        expected = (depth, per_quant if mode == "int8" else 0, per_quant if mode == "int4" else 0)
        reset_launch_counters()
        latencies, per_request = [], []
        with flash_masks() as seen:
            for req in requests:
                before = serving_launches()
                _seed_host()
                out = policy.infer(req)
                per_request.append(tuple(a - b for a, b in zip(serving_launches(), before)))
                latencies.append(out["policy_timing"]["infer_ms"])
                actions = np.asarray(out["actions"])
                if actions.shape != (10, 7) or not np.isfinite(actions).all():
                    raise AssertionError(f"vla0 {mode}: the vla0 output stack gave {actions.shape}")
        if any(c != expected for c in per_request):
            raise AssertionError(f"vla0 {mode}: expected {expected} (flash, int8, int4) launches, got {per_request}")
        for key, n in zip(("fwd", "int8", "int4"), serving_launches(), strict=True):
            launches[key] += n
        check_case_masks(seen, {VLA0_AR_CASE: cases[VLA0_AR_CASE]}, f"vla0 AR {mode}")
        prefill = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            model.ar_prefill(obs, AR_STEPS)
            torch.cuda.synchronize()
            prefill.append((time.monotonic() - t1) * 1e3)
        p50, p90 = percentiles(latencies)
        prefill_ms = statistics.median(prefill)
        numbers[mode] = {"p50_ms": p50, "p90_ms": p90, "ms_per_token": p50 / AR_STEPS, "prefill_ms": prefill_ms,
                         "decode_ms_per_token": (p50 - prefill_ms) / AR_STEPS,
                         "launches_per_request": list(expected), "dequant_launches_per_token": per_token}
        log(f"vla0 AR {mode}: {AR_STEPS} tokens per raw request at batch 1, (flash, int8, int4) launches per request "
            f"{expected}; infer p50_ms={p50:.3f} p90_ms={p90:.3f} ms_per_token={p50 / AR_STEPS:.3f} "
            f"prefill_ms={prefill_ms:.3f} decode_ms_per_token={(p50 - prefill_ms) / AR_STEPS:.3f} "
            f"all_ms={[round(x, 3) for x in latencies]} reasoning[:40]={str(out.get('reasoning'))[:40]!r}")
        short = ARPolicy(model, max_decoding_steps=AR_PROFILE_STEPS, stop_on_eos=False, seed=0)
        calls = per_token * AR_PROFILE_STEPS + 1 if mode != "bf16" else 0
        events, wall_ms = profile_cuda(lambda: short.infer(variant_prepared(VLA0_CONFIG, True)),
                                       f"vla0 AR request ({mode}, {AR_PROFILE_STEPS} tokens)", PROFILE_COUNT_PAD_S)
        profiled = report_profile(events, f"vla0 AR request ({mode}, {AR_PROFILE_STEPS} tokens)", wall_ms,
                                  AR_PROFILE_STEPS)
        numbers[mode]["profile"] = {"tokens": AR_PROFILE_STEPS, "dequant_kernels": profiled, "dequant_calls": calls}
        if not PROFILE_KEPT_SHARE * calls <= profiled <= calls:
            raise AssertionError(f"vla0 {mode}: the profile holds {profiled} dequant kernels for {calls} calls")
    model.quantize_(None)
    with flash_masks() as seen:
        check_ar_kernels_against_plain(model, train_config.model, device,
                                       request=variant_prepared(VLA0_CONFIG, True))
    check_case_masks(seen, {VLA0_FORCED_CASE: cases[VLA0_FORCED_CASE]}, "vla0 teacher-forced check")
    numbers["launches"] = launches
    del model
    release()
    return numbers


def lora_checksums(model, names) -> dict:
    """An int64 sum of each named parameter's bits (a change of any bit
    changes it with near certainty)."""
    import torch

    params = dict(model.named_parameters())
    with torch.no_grad():
        sums = [params[n].detach().reshape(-1).view(torch.int16 if params[n].element_size() == 2 else torch.int32)
                .to(torch.int64).sum() for n in names]
        return dict(zip(names, torch.stack(sums).cpu().tolist(), strict=True)) if sums else {}


def run_lora_training(device) -> dict:
    """Phase 15.4: LoRA training at full width (``lap`` with gemma_2b_lora and
    gemma_300m_lora, float32 parameters, AdamW, EMA) through the trainer on
    the fake loader's first batch, LORA_TRAIN_STEPS steps, no checkpoint."""
    import torch

    from lap_tpu_torch.models import convert
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.training import train as port_train

    config = lora_train_config()
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    trainer = port_train.build_trainer(config, device=device)
    state, model = trainer.state, trainer.model
    names = [n for n, _ in model.named_parameters()]
    trainable = set(state.trainable)
    frozen = [n for n in names if n not in trainable]
    lora_names = [n for n in names if "lora" in n]
    by_kind = {"lora": 0, "img": 0, "other": 0}
    for n in state.trainable:
        by_kind["lora" if "lora" in n else "img" if n.startswith("img.") else "other"] += 1
    sizes = {k: sum(dict(model.named_parameters())[n].numel() for n in state.trainable
                    if ("lora" if "lora" in n else "img" if n.startswith("img.") else "other") == k) for k in by_kind}
    opt_elems = sum(t.numel() for ts in state.opt_state.buffers().values() for t in ts)
    numbers = {"params": sum(p.numel() for p in model.parameters()), "trainable_tensors": by_kind,
               "trainable_elems": sizes, "frozen_tensors": len(frozen), "optimizer_state_elems": opt_elems,
               "ema_tensors": len(state.ema_params or {})}
    if not lora_names or any("lora" in n for n in frozen) or any(
            n.startswith("llm.") and "lora" not in n for n in trainable):
        raise AssertionError("lora: the freeze filter left an llm leaf trainable or froze an adapter")
    log(f"lora: built the LoRA trainer in {time.monotonic() - t0:.1f} s: {numbers['params']} params, trainable "
        f"tensors {by_kind} ({sizes} elements: every llm leaf but the adapters is frozen, JAX's rule leaves the "
        f"image encoder and the action projections trainable), {len(frozen)} frozen; optimizer state "
        f"{opt_elems} elements over the trainable leaves only; EMA over {numbers['ema_tensors']} tensors")
    batch = lora_train_batch(device)
    actions = batch[1]
    gen = torch.Generator(device=device).manual_seed(9)
    noise = torch.randn(actions.shape, generator=gen, device=device)
    time_ = torch.rand((actions.shape[0],), generator=gen, device=device) * 0.999 + 0.001

    def fixed_loss() -> float:
        with torch.no_grad():
            return model.compute_loss(*batch, train=False, noise=noise, time=time_)[0].item()

    loss_before = fixed_loss()
    frozen_before = lora_checksums(model, frozen)
    lora_before = lora_checksums(model, lora_names)

    def counts():
        return (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.launches_bwd_delta, fa.launches_bwd_group_sum)

    trainer.run(batch, 1)  # the first step allocates the gradients and moments
    cases = {LORA_TRAIN_CASE: lora_training_mask(device)}
    reset_launch_counters()
    records, per_step = [], []
    with flash_masks() as seen:
        for _ in range(LORA_TRAIN_STEPS - 1):
            before = counts()
            records += trainer.run(batch, 1)
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
    check_case_masks(seen, cases, "lora training")
    del seen
    launches = dict(zip(("fwd", "dq", "dkv", "delta", "group_sum"), counts(), strict=True))
    depth = len(model.llm.layers)
    expected = (2 * depth, depth, depth, depth, depth)
    if any(c != expected for c in per_step):
        raise AssertionError(f"lora: expected {expected} launches a step, got {per_step}")
    loss_after = fixed_loss()
    frozen_after = lora_checksums(model, frozen)
    lora_after = lora_checksums(model, lora_names)
    moved = sum(lora_after[n] != lora_before[n] for n in lora_names)
    changed_frozen = [n for n in frozen if frozen_after[n] != frozen_before[n]]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [r["step_ms"] for r in records]
    numbers.update(loss_fixed_before=loss_before, loss_fixed_after=loss_after, lora_moved=[moved, len(lora_names)],
                   frozen_changed=len(changed_frozen), peak_mem_gib=peak_gib, step_ms=step_ms,
                   step_ms_median=statistics.median(step_ms), launches_per_step=list(expected),
                   losses=[r["loss"] for r in records], launches=launches,
                   jax_paths=len({convert.jax_path(n) for n in names}))
    log(f"lora: {LORA_TRAIN_STEPS} steps at batch {TRAIN_BATCH} (float32 params, bf16 activations): launches a step "
        f"(fwd, dq, dkv, delta, group_sum) {per_step[0]}; step_ms={[round(x, 1) for x in step_ms]} "
        f"(median {numbers['step_ms_median']:.1f}); loss at fixed noise and time {loss_before:.6f} -> {loss_after:.6f}; "
        f"adapters moved {moved} of {len(lora_names)}; frozen leaves changed {len(changed_frozen)} of {len(frozen)}; "
        f"peak_mem_gib={peak_gib:.2f}")
    if changed_frozen or moved != len(lora_names) or not loss_after < loss_before:
        raise AssertionError(f"lora: frozen changed {changed_frozen[:3]}, adapters moved {moved}/{len(lora_names)}, "
                             f"loss {loss_before} -> {loss_after}")
    profile_one_step(trainer, batch)  # device time by kernel family, against the full step's (phase 11)
    del trainer, state, model, batch
    release()
    return numbers


def run_variants(device) -> dict:
    """Phase 15 (module header): FAST, pi0, vla0 serving on the LAP-3B tree,
    then LoRA training; returns the numbers and the phase's launches."""
    import torch

    from lap_tpu_torch.training.config import get_config

    reset_launch_counters()
    t0 = time.monotonic()
    config = get_config(FAST_CONFIG).model
    base = config.create_module(device=device, init_seed=0)
    torch.cuda.synchronize()
    log(f"variants: built LAP-3B for {FAST_CONFIG} ({sum(p.numel() for p in base.parameters())} params, bf16, "
        f"max_token_len {config.max_token_len}) in {time.monotonic() - t0:.1f} s")
    totals = dict(fwd=0, dq=0, dkv=0, delta=0, group_sum=0, int8=0, int4=0)
    numbers = {}
    phases = (("fast", lambda: run_fast_serving(base, device)), ("pi0", lambda: run_pi0_serving(base, device)),
              ("vla0", lambda: run_vla0_serving(base, device)), ("lora", lambda: run_lora_training(device)))
    for name, fn in phases:
        if name == "lora":
            del base
            release()
        t1 = time.monotonic()
        numbers[name] = fn()
        numbers[name]["phase_s"] = time.monotonic() - t1
        for key, n in numbers[name]["launches"].items():
            totals[key] += n
    numbers["launches"] = totals
    log(f"variants: phase 15 took {time.monotonic() - t0:.1f} s; main-path launches {totals}")
    print(json.dumps({"variants": numbers}), flush=True)
    return totals


def time_variant_flash_forward(device) -> dict:
    """The flash forward at phase 15's new prefills (the FAST flow prefix,
    B=1 T=S=732, and the vla0 AR prefill, B=1 T=902 S=966) by device time,
    beside its plain version, SDPA's device time (a yardstick) and the bound."""
    import torch
    import torch.nn.functional as F

    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(19)
    cases = {n: m for n, _, m in variant_kernel_cases(device)}
    out = {}
    for name in (FAST_FLOW_CASE, VLA0_AR_CASE):
        mask = cases[name]
        t, s = mask.shape[1:]
        q = torch.randn((1, t, 8, 256), generator=g, device=device).to(torch.bfloat16)
        k, v = (torch.randn((1, s, 1, 256), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
        device_ms = device_ms_per_call([lambda: fa.flash_attention_forward(q, k, v, mask)], iters=50)
        plain_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, mask), iters=10)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = device_ms_per_call(
            [lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)], iters=50)
        bound_ms, bound_by, flops_ms, bytes_ms = flash_forward_bound(mask, q, k, v)
        out[name] = dict(device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"timing flash_attention_fwd {name} B1 T{t} S{s} N8 K1 H256: device_ms={device_ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms(sdpa, device time)={library_ms:.5f} bound_ms={bound_ms:.5f} "
            f"({bound_by}: flops -> {flops_ms:.5f} ms, bytes -> {bytes_ms:.5f} ms; {int(mask.sum())} pairs)")
    return out


# ---------------------------------------------------------------------------
# Phase 16: lap_libero trained from RLDS episodes (the data pipeline)
# ---------------------------------------------------------------------------

RLDS_DATASETS = ("libero_10_no_noops", "libero_goal_no_noops", "libero_object_no_noops", "libero_spatial_no_noops")
RLDS_EPISODES = 8  # a dataset
RLDS_EPISODE_STEPS = 100
RLDS_FRAME = 256  # primary and wrist frames, JPEG at RLDS_QUALITY
RLDS_QUALITY = 95
RLDS_TRAIN_STEPS = 6  # run 1; run 2 resumes and takes one more
RLDS_LOADER_BATCHES = 24  # the loader alone, after its first batch
RLDS_DECODE_SAMPLES = 64
RLDS_TASKS = ("put the bowl on the plate", "open the top drawer", "pick up the ketchup", "turn on the stove",
              "put the cream cheese in the bowl", "push the plate to the front of the stove",
              "put the wine bottle on top of the cabinet", "pick up the black bowl next to the cookie box")


def rlds_camera_frames(seed: int, wrist: bool) -> list:
    """One episode's frames of one camera: a colour gradient, a disc that
    moves across it and mild sensor noise (a real frame's JPEG size, ~15-30
    KB at quality 95, not 150 KB of noise), encoded by the port's encoder."""
    import numpy as np

    from lap_tpu_torch.data.episode_pipeline import encode_jpeg

    rng = np.random.default_rng(seed)
    n = RLDS_FRAME
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    c0, c1 = rng.uniform(30, 225, (2, 3)).astype(np.float32)
    ramp = ((x + (0.5 if wrist else 1.0) * y) / (2 * n))[..., None]
    background = c0 + (c1 - c0) * ramp
    noise = rng.normal(0.0, 3.0, (2 * n, 2 * n, 3)).astype(np.float32)
    start, end = rng.uniform(0.2 * n, 0.8 * n, (2, 2))
    radius = rng.uniform(0.08, 0.16) * n * (2.0 if wrist else 1.0)
    colour = rng.uniform(0, 255, 3).astype(np.float32)
    frames = []
    for t in range(RLDS_EPISODE_STEPS):
        cy, cx = start + (end - start) * t / RLDS_EPISODE_STEPS
        img = background.copy()
        img[(x - cx) ** 2 + (y - cy) ** 2 < radius**2] = colour
        oy, ox = rng.integers(0, n, 2)
        img += noise[oy : oy + n, ox : ox + n]
        frames.append(encode_jpeg(np.clip(img, 0, 255).astype(np.uint8), RLDS_QUALITY))
    return frames


def rlds_episode(dataset: int, index: int, frames: tuple) -> dict:
    """A LIBERO-shaped raw episode (``libero_dataset_transform``'s input):
    8 state values (xyz, axis-angle, two gripper joints), 7 action values
    (deltas, gripper -1/1), one instruction."""
    import numpy as np

    rng = np.random.default_rng(1000 * dataset + index)
    t = RLDS_EPISODE_STEPS
    xyz = np.cumsum(rng.normal(0, 0.01, (t, 3)), axis=0) + rng.uniform(-0.3, 0.3, 3)
    axis_angle = np.cumsum(rng.normal(0, 0.02, (t, 3)), axis=0) + rng.uniform(-0.5, 0.5, 3)
    closed = (np.arange(t) > rng.integers(20, 80)).astype(np.float32)
    gripper = np.stack([0.04 * (1 - closed), -0.04 * (1 - closed)], -1)
    action = np.concatenate([np.diff(xyz, axis=0, append=xyz[-1:]) * 50, rng.normal(0, 0.1, (t, 3)),
                             2 * closed[:, None] - 1], -1)
    return {"steps": {
        "observation": {"image": frames[0], "wrist_image": frames[1],
                        "state": np.concatenate([xyz, axis_angle, gripper], -1).astype(np.float32)},
        "action": action.astype(np.float32),
        "language_instruction": [RLDS_TASKS[(dataset * RLDS_EPISODES + index) % len(RLDS_TASKS)]] * t,
    }}


def write_rlds_phase_dataset(root: Path) -> dict:
    """The four libero_*_no_noops datasets, RLDS_EPISODES episodes each, in
    ``root`` (the frames made and encoded on 8 threads)."""
    from lap_tpu_torch.data import rlds

    t0 = time.monotonic()
    jobs = [(d, i, wrist) for d in range(len(RLDS_DATASETS)) for i in range(RLDS_EPISODES) for wrist in (False, True)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        frames = dict(zip(jobs, pool.map(lambda j: rlds_camera_frames(10_000 * j[0] + 10 * j[1] + j[2], j[2]), jobs)))
    encode_s = time.monotonic() - t0
    sizes = [len(f) for cams in frames.values() for f in cams]
    for d, name in enumerate(RLDS_DATASETS):
        rlds.write_rlds_dataset(root, name, [rlds_episode(d, i, (frames[d, i, False], frames[d, i, True]))
                                             for i in range(RLDS_EPISODES)])
    seconds = time.monotonic() - t0
    nbytes = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    return dict(write_s=seconds, encode_s=encode_s, bytes=nbytes, frames=len(sizes),
                jpeg_kb_mean=sum(sizes) / len(sizes) / 1e3, jpeg_kb_min=min(sizes) / 1e3,
                jpeg_kb_max=max(sizes) / 1e3)


def time_rlds_steps(trainer, data_iter, steps: int) -> dict:
    """``train.run``'s step clock on a trainer built by hand: each step's wait
    for its batch, then the step until its metrics are on the host."""
    from lap_tpu_torch.training.train import reduce_metrics

    waits, step_ms, losses = [], [], []
    for _ in range(steps):
        t_wait = time.monotonic()
        batch = next(data_iter)
        t0 = time.monotonic()
        waits.append(t0 - t_wait)
        trainer.state, metrics = trainer.steps.train_step(trainer.state, batch)
        losses.append(reduce_metrics(metrics)["loss"])  # syncs the device
        step_ms.append((time.monotonic() - t0) * 1e3)
    return dict(data_wait_s=waits, step_ms=step_ms, losses=losses)


def run_rlds_training(device):
    """Phase 16: ``train.main`` with ``lap_libero`` at full width (both
    experts cut to TRAIN_PHASE_DEPTH layers) from RLDS episodes written to a
    directory of the checkout: the dataset's write, the norm-stats pass, the
    loader alone; run 1 takes RLDS_TRAIN_STEPS steps and saves; the loss of
    the next batch on run 1's state; run 2 resumes and takes one step (its
    loss equal to that loss, bit for bit: the loader's position restored
    across the mixture); the same model fed by the ``fake`` repo at the same
    settings, for the step time. The dataset and the run directory are
    deleted at the end, also on failure."""
    import shutil
    import tempfile

    import torch

    from lap_tpu_torch.data import loader as port_loader
    from lap_tpu_torch.data.episode_pipeline import make_image_decoder
    from lap_tpu_torch.data.mixer import build_rlds_dataset
    from lap_tpu_torch.models import gemma
    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.config import cli
    from lap_tpu_torch.training.train_step import step_generator

    variants = []
    for base in ("gemma_2b", "gemma_300m"):
        name = f"{base}_depth{TRAIN_PHASE_DEPTH}"
        gemma._VARIANTS[name] = {**gemma._VARIANTS[base], "depth": TRAIN_PHASE_DEPTH}
        variants.append(name)
    data_dir = Path(tempfile.mkdtemp(prefix=".rlds_phase_", dir=REPO))
    run_dir = Path(tempfile.mkdtemp(prefix=".train_phase_", dir=REPO))
    numbers = {"depth": TRAIN_PHASE_DEPTH, "batch": TRAIN_BATCH, "dtype": TRAIN_PHASE_DTYPE}
    launches = dict(fwd=0, dq=0, dkv=0, delta=0, group_sum=0)
    try:
        numbers["dataset"] = write_rlds_phase_dataset(data_dir)
        ds = numbers["dataset"]
        log(f"rlds: wrote {len(RLDS_DATASETS)} datasets x {RLDS_EPISODES} episodes x {RLDS_EPISODE_STEPS} steps "
            f"({ds['frames']} JPEG frames of {RLDS_FRAME}^2 at quality {RLDS_QUALITY}, {ds['jpeg_kb_mean']:.1f} KB "
            f"mean, {ds['jpeg_kb_min']:.1f}-{ds['jpeg_kb_max']:.1f}) in {ds['write_s']:.2f} s (frames made and "
            f"encoded on 8 threads in {ds['encode_s']:.2f} s): {ds['bytes']} bytes")
        config_args = ["lap_libero", "--exp_name", "rlds", "--checkpoint_base_dir", str(run_dir),
                       "--data.rlds_data_dir", str(data_dir), "--weight_loader.kind", "none",
                       "--batch_size", str(TRAIN_BATCH), "--param_dtype", TRAIN_PHASE_DTYPE,
                       "--freeze_vlm", TRAIN_PHASE_FREEZE_VLM, "--save_interval", "1000", "--log_interval", "1",
                       "--model.paligemma_variant", variants[0], "--model.action_expert_variant", variants[1]]
        config = cli(config_args)
        if config.model.action_horizon != LIBERO_HORIZON:
            raise AssertionError(f"lap_libero's horizon is {config.model.action_horizon}, not {LIBERO_HORIZON}")

        # The norm-stats pass (writes norm_stats_cache/libero_finetune.json).
        t0 = time.monotonic()
        dataset, norm_stats = build_rlds_dataset(config)
        numbers["norm_stats_s"] = time.monotonic() - t0
        log(f"rlds: norm-stats pass over {len(RLDS_DATASETS) * RLDS_EPISODES} episodes in "
            f"{numbers['norm_stats_s']:.2f} s; action q99 {norm_stats['actions'].q99[:7].round(4).tolist()}")

        # Decode + resize alone, one thread: host ms a sample (two frames).
        decode = make_image_decoder(config.data.resize_resolution)
        raw_iter = iter(dataset)
        raw = [next(raw_iter) for _ in range(RLDS_DECODE_SAMPLES)]
        t0 = time.monotonic()
        for sample in raw:
            decode(sample)
        numbers["decode_ms_per_sample"] = (time.monotonic() - t0) * 1e3 / len(raw)
        del raw, raw_iter, dataset

        # The loader alone: batches of TRAIN_BATCH on its 8 threads, to the card.
        loader = port_loader.create_data_loader(config, device=device)
        t0 = time.monotonic()
        it = iter(loader)
        obs, actions = next(it)
        numbers["first_batch_s"] = time.monotonic() - t0
        if tuple(actions.shape) != (TRAIN_BATCH, LIBERO_HORIZON, 7) or not torch.isfinite(actions).all() or \
                tuple(obs.images["base_0_rgb"].shape) != (TRAIN_BATCH, 224, 224, 3):
            raise AssertionError(f"rlds loader: actions {tuple(actions.shape)}, images "
                                 f"{tuple(obs.images['base_0_rgb'].shape)}")
        t0 = time.monotonic()
        for _ in range(RLDS_LOADER_BATCHES):
            next(it)
        numbers["loader_samples_per_s"] = RLDS_LOADER_BATCHES * TRAIN_BATCH / (time.monotonic() - t0)
        it.close()
        del loader, it, obs, actions
        log(f"rlds: the loader alone (batch {TRAIN_BATCH}, 8 threads, to the card): first batch in "
            f"{numbers['first_batch_s']:.3f} s, then {numbers['loader_samples_per_s']:.1f} samples/s over "
            f"{RLDS_LOADER_BATCHES} batches; decode + resize {numbers['decode_ms_per_sample']:.3f} host ms a sample "
            f"(two {RLDS_FRAME}^2 JPEGs to 224^2, one thread)")

        def args(*extra):
            return [*config_args, "--device", str(device), *extra]

        def count(before, what):
            got = tuple(a - b for a, b in zip(flash_and_backward_launches(), before, strict=True))
            for key, n in zip(("fwd", "dq", "dkv", "delta", "group_sum"), got, strict=True):
                launches[key] += n
            log(f"rlds: {what}: launches (fwd, dq, dkv, delta, group_sum) {got}")
            return got

        # Run 1: RLDS_TRAIN_STEPS steps from the seed, a save at the last.
        release()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counters()
        t0 = time.monotonic()
        with flash_masks() as seen:
            first = port_train.main(args("--num_train_steps", str(RLDS_TRAIN_STEPS)))
        numbers["run1_s"] = time.monotonic() - t0
        numbers["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        got = count((0,) * 5, f"run 1 ({RLDS_TRAIN_STEPS} steps)")
        depth = len(first.trainer.model.llm.layers)
        per_step = (2 * depth, depth, depth, depth, depth)  # as phase 13
        if got != tuple(RLDS_TRAIN_STEPS * n for n in per_step):
            raise AssertionError(f"run 1: expected {RLDS_TRAIN_STEPS} x {per_step} launches, got {got}")
        shapes = {tuple(m.shape) for m in seen}
        if shapes != {(TRAIN_BATCH, LIBERO_JOINT, LIBERO_JOINT)}:
            raise AssertionError(f"run 1: the flash forward's masks have shapes {shapes}, not the "
                                 f"{RLDS_TRAIN_CASE} case's")
        timings = first.timings
        numbers.update(step_ms=timings["step_ms"], data_wait_s=timings["data_wait_s"],
                       median_step_ms=statistics.median(timings["step_ms"][1:]),
                       median_data_wait_ms=statistics.median(timings["data_wait_s"][1:]) * 1e3,
                       losses=[first.metrics.get("loss")],
                       write_bytes=first.checkpoints.last_save["bytes"], write_s=first.checkpoints.last_save["seconds"],
                       save_blocked_s=first.checkpoints.last_save["blocked_s"],
                       save_wait_s=timings["save_wait_s"])
        state = first.trainer.state
        cursor = first.loader.state_dict()
        batch = next(first.data_iter)
        before = flash_and_backward_launches()
        loss, _ = first.trainer.model.compute_loss(
            *batch, train=True, generator=step_generator(first.trainer.config.seed, state.step, device))
        next_loss = loss.item()
        count(before, "next batch's loss on run 1's state")
        log(f"rlds: run 1 took {numbers['run1_s']:.1f} s: step ms {[round(t, 1) for t in timings['step_ms']]} "
            f"(median of steps 2-{RLDS_TRAIN_STEPS} {numbers['median_step_ms']:.1f}), waits for the batch "
            f"{[round(w * 1e3, 2) for w in timings['data_wait_s']]} ms (median of steps 2-{RLDS_TRAIN_STEPS} "
            f"{numbers['median_data_wait_ms']:.2f}), peak {numbers['peak_gib']:.2f} GiB; the {len(seen)} flash "
            f"forward masks of shape {sorted(shapes)}; saved step {state.step} ({numbers['write_bytes']} bytes in "
            f"{numbers['write_s']:.2f} s; save() blocked {numbers['save_blocked_s']:.2f} s); loader cursor "
            f"{cursor}; next batch's loss {next_loss!r}")
        first.close()
        del first, state, batch, loss
        release()

        # Run 2: resume and take one step: the loss of the batch the
        # uninterrupted stream gives next, on run 1's state.
        reset_launch_counters()
        t0 = time.monotonic()
        second = port_train.main(args("--num_train_steps", str(RLDS_TRAIN_STEPS + 1), "--resume", "true"))
        numbers["run2_s"] = time.monotonic() - t0
        got = count((0,) * 5, "run 2 (resumed, one step)")
        if got != per_step:
            raise AssertionError(f"run 2: expected {per_step} launches, got {got}")
        resumed_loss = second.metrics["loss"]
        numbers.update(resumed_loss=resumed_loss, next_loss=next_loss, restore_s=second.timings["restore_s"],
                       resumed_first_wait_s=second.timings["data_wait_s"][0])
        log(f"rlds: run 2 restored step {RLDS_TRAIN_STEPS} in {numbers['restore_s']:.2f} s, waited "
            f"{numbers['resumed_first_wait_s']:.2f} s for its first batch (the stream replayed to its position), "
            f"first loss {resumed_loss!r} vs run 1's next batch {next_loss!r}")
        if resumed_loss != next_loss:
            raise AssertionError("rlds: the resumed run's first loss differs from the uninterrupted stream's")
        second.close()
        del second
        release()

        # The same model, settings and step clock fed by the fake repo.
        fake_config = cli([*config_args, "--data.repo_id", "fake", "--data.data_mix", "none"])
        trainer = port_train.build_trainer(fake_config, device=device)
        fake_iter = iter(port_loader.create_data_loader(fake_config, device=device))
        reset_launch_counters()
        fake = time_rlds_steps(trainer, fake_iter, RLDS_TRAIN_STEPS)
        got = count((0,) * 5, f"the fake repo's {RLDS_TRAIN_STEPS} steps")
        if got != tuple(RLDS_TRAIN_STEPS * n for n in per_step):
            raise AssertionError(f"fake feed: expected {RLDS_TRAIN_STEPS} x {per_step} launches, got {got}")
        fake_iter.close()
        del trainer, fake_iter
        release()
        numbers["fake"] = dict(fake, median_step_ms=statistics.median(fake["step_ms"][1:]),
                               median_data_wait_ms=statistics.median(fake["data_wait_s"][1:]) * 1e3)
        log(f"rlds: the fake repo at the same settings: step ms {[round(t, 1) for t in fake['step_ms']]} (median "
            f"{numbers['fake']['median_step_ms']:.1f} against {numbers['median_step_ms']:.1f} from RLDS), waits "
            f"{numbers['fake']['median_data_wait_ms']:.2f} ms (RLDS {numbers['median_data_wait_ms']:.2f}); the RLDS "
            f"loader gives {numbers['loader_samples_per_s']:.1f} samples/s against the "
            f"{TRAIN_BATCH / numbers['median_step_ms'] * 1e3:.1f} the steps take")
        if not all(math.isfinite(x) for x in fake["losses"]):
            raise AssertionError(f"fake feed: losses {fake['losses']}")
        numbers["launches"] = dict(launches)
        print(json.dumps({"rlds_training": numbers}), flush=True)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
        shutil.rmtree(run_dir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 17: parallelism past one card
# ---------------------------------------------------------------------------

# Two ranks share the one card of this run: NCCL refuses two ranks on one
# device ("Duplicate GPU detected"), and gloo runs every collective the port
# needs on CUDA tensors (all-reduce, broadcast, all-gather, reduce-scatter,
# FSDP2's unshard and reduce-scatter), but crashes in DTensor's functional
# collectives, which the port does not call (PERF.md, the probe of the card).
PARALLEL_BACKEND = "gloo"
SINGLE_RANK_BACKEND = "nccl"  # a 1-rank world runs the same entry points on NCCL
PARALLEL_DEVICE = "cuda:0"  # every rank's device: the one card
TP_RANKS = 2
PARALLEL_TIMEOUT_S = 900
TP_FLOW_REQUESTS = 4
TP_AR_REQUESTS = 2
TP_AR_TOKENS = 16
AR_TP_FLOOR_FACTOR = 2.0  # tp's AR logits may differ from one process's by twice its flash-vs-einsum floor
PARALLEL_TRAIN_STEPS = 3
# A sharded run against one process of the same seed. Its activations are
# bf16, so each rank's partial products (4 of 8 heads, half the hidden dim, 4
# of 8 rows) are rounded to bf16 before they are summed, where one process
# rounds the whole product once: that, not the order of the sums, moves the
# loss by ~1e-5 and the grad norm by ~2e-4 (measured on an H100).
PARALLEL_LOSS_REL_TOL = 1e-4
PARALLEL_GRAD_NORM_REL_TOL = 1e-3
# Every leaf of the first step's gradient (the same parameters in both runs):
# its squared norm and its projections on GRAD_PROJECTIONS Gaussian directions
# seeded by the leaf's name. A leaf's difference from one process (the larger
# of its norm's and of the projections' root-mean-square difference, an
# estimate of the l2 norm of the difference) must stay within
# GRAD_LEAF_REL_TOL of its norm plus GRAD_LEAF_FLOOR of the whole gradient's
# (leaves whose exact gradient is zero, as SigLIP's key biases, hold rounding
# alone). A sum over the ranks left out drops one rank's share of the leaf:
# about half its norm or more.
GRAD_PROJECTIONS = 3
GRAD_LEAF_REL_TOL = 0.2
GRAD_LEAF_FLOOR = 1e-4
PARALLEL_TRAIN_BATCH = 8  # the global batch: 4 rows a data rank under FSDP
PARALLEL_TRAIN_DTYPE = "float32"  # the recipe's parameters; activations stay the config's bf16
# The 12B and 27B plans are arithmetic on the meta device: no rank holds them.
PLANNED_CONFIGS = ("lap_gemma3_12b", "lap_gemma3_27b")
PLANNED_MESHES = ({"fsdp": 4}, {"fsdp": 2, "tp": 2})


def _parallel_rank(rank, world, port, backend, job, args, setup, out, inbox) -> None:
    """One rank of a spawned world: joins the process group, builds (loads)
    the kernels, waits for the rest of its arguments on ``inbox``, runs
    ``job(rank, world, *args, *rest)`` and reports its result."""
    import traceback

    try:
        sys.path.insert(0, str(REPO))
        import torch
        import torch.distributed as dist

        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        if setup is not None:
            module, name = setup.split(":")
            getattr(__import__(module), name)()
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            from lap_tpu_torch import cuda_build
            from lap_tpu_torch.ops import flash_attention as fa
            from lap_tpu_torch.ops import int4_matmul as i4
            from lap_tpu_torch.ops import int8_matmul as i8

            for source in (fa.SOURCE, fa.BWD_SOURCE, i8.SOURCE, i4.SOURCE):
                cuda_build.build(source)  # built by the parent: found on disk
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        rest = inbox.get()
        result = globals()[job](rank, world, *args, *rest)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        out.put((rank, False, traceback.format_exc()))


def jobs_in_turn(rank, world, jobs):
    """Several jobs in one spawned world (a world takes ~20 s to start): each
    ``(job, args)`` in turn, the card's memory given back between them."""
    results = []
    for job, args in jobs:
        results.append(globals()[job](rank, world, *args))
        release()
    return results


@contextlib.contextmanager
def parallel_world(world: int, backend: str, job: str, *args, setup: str | None = None,
                   timeout: float = PARALLEL_TIMEOUT_S):
    """Spawn ``world`` ranks (all on card 0) at once; they start up (~20 s)
    while the caller works on. Yields ``results(*rest)``, which lets the
    ranks run ``job(rank, world, *args, *rest)`` and returns their results by
    rank. A rank that fails fails the
    phase with its traceback; a job past ``timeout`` is killed and fails it.
    Every rank is stopped when the block ends."""
    import queue
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out, inbox = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_parallel_rank, args=(r, world, port, backend, job, args, setup, out, inbox))
             for r in range(world)]
    for p in procs:
        p.start()

    def results(*rest) -> list:
        for _ in procs:
            inbox.put(rest)
        results, errors, deadline = {}, {}, time.monotonic() + timeout
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(f"parallel: {job} on {world} ranks did not finish in {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    raise AssertionError(f"parallel: a rank of {job} died with exit code {dead[0]}") from None
                if errors:
                    break
                continue
            (results if ok else errors)[rank] = value
        if errors:
            raise AssertionError("\n".join(f"parallel: rank {r} of {job} failed:\n{v}" for r, v in sorted(errors.items())))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [results[r] for r in range(world)]

    try:
        yield results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def _recording_runs(policy):
    """Wrap the policy's model calls: each call's prepared batch, its (flash,
    int8, int4) launches and what it sampled."""
    calls = []
    run = policy._run

    def recorded(batch, step):
        before = serving_launches()
        sampled = run(batch, step)
        calls.append(dict(batch=batch, launches=tuple(a - b for a, b in zip(serving_launches(), before)),
                          sampled=sampled))
        return sampled

    policy._run = recorded
    return calls


def forced_logits(model, batch, forced):
    """f32 logits [S + 1, V] of the AR prefill and of S decode steps fed the
    tokens ``forced`` [1, S] (teacher forcing), for one prepared batch."""
    import torch

    from lap_tpu_torch.models.types import CoTObservation

    obs = CoTObservation.from_dict(batch, device=model.device)
    forced = torch.as_tensor(forced, dtype=torch.int32, device=model.device)
    with torch.inference_mode():
        state = model.ar_prefill(obs, forced.shape[1])
        logits = [state.logits.float()]
        for i in range(forced.shape[1]):
            logits.append(model.ar_step(state, forced[:, i:i + 1]).float())
    return torch.cat(logits, dim=1)[0].cpu().numpy()


def tp_serving_job(rank, world, ckpt_dir, requests, host_seeds, device, ar_forced):
    """Phase 17a on each rank: ``create_trained_policy(..., tp=world)`` from
    phase 9's checkpoint directory, flow requests on rank 0 (the other ranks
    follow), then ``create_trained_policy_ar`` for TP_AR_TOKENS greedy tokens
    and, on every rank, the teacher-forced logits of ``ar_forced`` (the
    one-process policy's tokens)."""
    import numpy as np
    import torch

    from lap_tpu_torch.policies import policy as port_policy
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.training.config import get_config

    lap = get_config("lap")
    kw = dict(default_prompt=DEFAULT_PROMPT, allow_test_vocab=True, tp=world, device=device)
    result = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    flow = policy_config.create_trained_policy(lap, ckpt_dir, **kw)
    torch.cuda.synchronize()
    result["restore_s"] = time.monotonic() - t0
    result["resident_gb"] = torch.cuda.memory_allocated() / 2**30
    calls = _recording_runs(flow)
    if rank == 0:
        actions, ms = [], []
        for req, seed in zip(requests, host_seeds, strict=True):
            np.random.seed(seed)
            t0 = time.monotonic()
            actions.append(flow.infer(req)["actions"])
            ms.append((time.monotonic() - t0) * 1e3)
        port_policy.stop_followers(flow)
        result.update(actions=actions, infer_ms=ms)
    else:
        port_policy.serve_followers(flow)
    result["flow_launches"] = [c["launches"] for c in calls]
    del flow, calls
    release()
    ar = policy_config.create_trained_policy_ar(lap, ckpt_dir, max_decoding_steps=TP_AR_TOKENS, **kw)
    calls = _recording_runs(ar)
    if rank == 0:
        ms = []
        for req, seed in zip(requests[:TP_AR_REQUESTS], host_seeds[:TP_AR_REQUESTS], strict=True):
            np.random.seed(seed)
            t0 = time.monotonic()
            ar.infer(req)
            ms.append((time.monotonic() - t0) * 1e3)
        port_policy.stop_followers(ar)
        result.update(ar_ms=ms, tokens=[np.asarray(c["sampled"]) for c in calls])
    else:
        port_policy.serve_followers(ar)
    result["ar_launches"] = [c["launches"] for c in calls]
    # Teacher forcing on every rank (each call is collective).
    logits = [forced_logits(ar._model, batch, tokens) for batch, tokens in ar_forced]
    if rank == 0:
        result["forced_logits"] = logits
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return result


def _step_rel(got, ref) -> float:
    """The largest per-step relative l2 difference of two [S, V] logit arrays."""
    import numpy as np

    return float(max(np.linalg.norm(got[i] - ref[i]) / np.linalg.norm(ref[i]) for i in range(len(ref))))


def _margins(logits):
    """Per step: the top-1 minus top-2 logit."""
    import numpy as np

    top2 = np.partition(logits, -2, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def run_tp_serving(ckpt_dir: Path, config, device) -> dict:
    """Phase 17a: tp = 2 flow and AR serving of LAP-3B at full width from
    phase 9's checkpoint directory (two ranks on one card), against the
    one-process policies of the same directory and seeds: flow actions
    within PATH_REL_TOL; the AR logits teacher-forced with one process's
    greedy tokens within PATH_REL_TOL a step, and the tp policy's own greedy
    tokens equal to one process's at every step before the first whose top-2
    logit margin is within twice the step's largest logit difference (a
    near tie that the two paths' roundings may break either way; random
    weights make them common)."""
    import numpy as np

    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.training.config import get_config

    t_phase = time.monotonic()
    lap = get_config("lap")
    requests = [raw_request(900 + i, config) for i in range(TP_FLOW_REQUESTS)]
    seeds = [30 + i for i in range(TP_FLOW_REQUESTS)]
    # The one-process references first (the ranks start up meanwhile): the
    # same directory, seeds and requests.
    with parallel_world(TP_RANKS, PARALLEL_BACKEND, "tp_serving_job", ckpt_dir, requests, seeds,
                        PARALLEL_DEVICE) as tp_world:
        kw = dict(default_prompt=DEFAULT_PROMPT, allow_test_vocab=True, device=device)
        single = policy_config.create_trained_policy(lap, ckpt_dir, **kw)
        ref_actions = []
        for req, seed in zip(requests, seeds, strict=True):
            np.random.seed(seed)
            ref_actions.append(single.infer(req)["actions"])
        del single
        release()
        single_ar = policy_config.create_trained_policy_ar(lap, ckpt_dir, max_decoding_steps=TP_AR_TOKENS, **kw)
        ref_calls = _recording_runs(single_ar)
        for req, seed in zip(requests[:TP_AR_REQUESTS], seeds[:TP_AR_REQUESTS], strict=True):
            np.random.seed(seed)
            single_ar.infer(req)
        ar_forced = [(c["batch"], np.asarray(c["sampled"])) for c in ref_calls]
        ref_logits = [forced_logits(single_ar._model, batch, tokens) for batch, tokens in ar_forced]
        # The floor: one process's logits with einsum attention against its
        # flash attention (two roundings of the same function).
        single_ar._model.set_attn_impl("xla")
        floor = max(_step_rel(forced_logits(single_ar._model, batch, tokens), ref)
                    for (batch, tokens), ref in zip(ar_forced, ref_logits, strict=True))
        single_ar._model.set_attn_impl(single_ar._model.config.attn_impl)
        del single_ar, ref_calls
        release()
        ranks = tp_world(ar_forced)
    got = ranks[0]
    depth = 18
    for rank, r in enumerate(ranks):
        if r["flow_launches"] != [(depth, 0, 0)] * TP_FLOW_REQUESTS or r["ar_launches"] != [(depth, 0, 0)] * \
                TP_AR_REQUESTS:
            raise AssertionError(f"tp serving: rank {rank} launched (flash, int8, int4) {r['flow_launches']} a flow "
                                 f"request and {r['ar_launches']} an AR request; expected {depth} flash each")
    errs = [float(np.linalg.norm(a - r) / np.linalg.norm(r)) for a, r in zip(got["actions"], ref_actions,
                                                                            strict=True)]
    logit_tol = max(PATH_REL_TOL, AR_TP_FLOOR_FACTOR * floor)
    logit_errs, agree, ties = [], [], []
    for (_, ref_tokens), ref, tp_logits, tp_tokens in zip(ar_forced, ref_logits, got["forced_logits"],
                                                          got["tokens"], strict=True):
        step_err = np.abs(tp_logits - ref).max(axis=-1)
        logit_errs.append(_step_rel(tp_logits, ref))
        margin = _margins(ref)[:-1]  # the margin of the logits each greedy token was picked from
        near = np.nonzero(margin <= 2 * step_err[:-1])[0]
        first_tie = int(near[0]) if near.size else TP_AR_TOKENS
        ties.append(first_tie)
        n = min(first_tie, ref_tokens.shape[1], tp_tokens.shape[1])
        agree.append(bool(np.array_equal(tp_tokens[:, :n], ref_tokens[:, :n])))
    numbers = dict(
        backend=PARALLEL_BACKEND, ranks=TP_RANKS, flow_rel_err=errs, ar_forced_logits_rel_err=logit_errs,
        ar_logits_floor=floor, ar_logits_tol=logit_tol,
        ar_greedy_tokens_equal_before_first_near_tie=agree, ar_first_near_tie=ties,
        ar_tokens_all_equal=[bool(np.array_equal(t, r)) for t, (_, r) in zip(got["tokens"], ar_forced, strict=True)],
        flash_launches_per_rank=sum(c[0] for c in got["flow_launches"] + got["ar_launches"]),
        flash_launches=sum(c[0] for r in ranks for c in r["flow_launches"] + r["ar_launches"]),
        restore_s=[r["restore_s"] for r in ranks], resident_gb_per_rank=[r["resident_gb"] for r in ranks],
        peak_gb_per_rank=[r["peak_gb"] for r in ranks], flow_infer_ms=got["infer_ms"], ar_infer_ms=got["ar_ms"],
        seconds=time.monotonic() - t_phase)
    log(f"parallel 17a: tp={TP_RANKS} LAP-3B serving over {PARALLEL_BACKEND}, restored per rank in "
        f"{[round(x, 2) for x in numbers['restore_s']]} s ({[round(x, 2) for x in numbers['resident_gb_per_rank']]} "
        f"GiB resident a rank); flow actions vs one process rel_err={[f'{e:.3e}' for e in errs]} (tol "
        f"{PATH_REL_TOL}); AR teacher-forced logits vs one process rel_err={[f'{e:.3e}' for e in logit_errs]} (tol "
        f"{logit_tol:.3e}: the larger of {PATH_REL_TOL} and {AR_TP_FLOOR_FACTOR} x the floor {floor:.3e}, one "
        f"process's einsum against its flash attention); greedy tokens equal to one process's before the first near tie: {agree} (first near tie "
        f"at step {ties} of {TP_AR_TOKENS}; all {TP_AR_TOKENS} equal: {numbers['ar_tokens_all_equal']}); {depth} "
        f"flash launches per rank and request; latency, two ranks on one card (for information only, it says "
        f"nothing of tp over two cards): flow infer_ms={[round(x, 1) for x in got['infer_ms']]} AR infer_ms="
        f"{[round(x, 1) for x in got['ar_ms']]}; peak GiB a rank {[round(x, 2) for x in numbers['peak_gb_per_rank']]}")
    if max(errs) > PATH_REL_TOL or max(logit_errs) > logit_tol or not all(agree):
        raise AssertionError(f"tp serving: flow rel_err {errs}, AR logits rel_err {logit_errs} (tol {logit_tol}) "
                             f"or greedy tokens before a near tie {agree}")
    return numbers


def tp_gemma3_job(rank, world, request, noise, device):
    """Phase 17b on each rank: LAPGemma3-4B from seed 0, its slices copied
    from the whole weights by ``checkpoints.copy_shards`` (what
    ``restore_params_sharded`` runs), one flow request at explicit noise."""
    import dataclasses

    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import parallelize_
    from lap_tpu_torch.policies.policy import _stack_batch
    from lap_tpu_torch.training.checkpoints import copy_shards
    from lap_tpu_torch.training.config import get_config

    config = dataclasses.replace(get_config(G3_CONFIG).model, stop_action_to_vlm_grad=False)
    torch.cuda.reset_peak_memory_stats()
    whole = config.create_module(device=device, init_seed=0)
    weights = {n: p.detach() for n, p in whole.named_parameters()}
    model = config.create_module(device="meta", init_seed=None)
    parallelize_(model, mesh_lib.make_mesh(1, world, device_type=torch.device(device).type))
    model.to_empty(device=device)
    copy_shards(model, dict(model.named_parameters()), weights, "gemma3 weights")
    del whole, weights
    release()
    resident = torch.cuda.memory_allocated() / 2**30
    obs = CoTObservation.from_dict(_stack_batch([request]), device=device)
    reset_launch_counters()
    actions = model.sample_actions(obs, noise=torch.from_numpy(noise).to(device))
    launches = serving_launches()
    return dict(actions=actions.float().cpu().numpy(), launches=launches, resident_gb=resident,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30)


def tp_gemma3_noise(config):
    import numpy as np

    return np.random.default_rng(17).standard_normal((1, config.action_horizon, config.action_dim)).astype(np.float32)


def tp_gemma3_reference(config, request, noise, device) -> dict:
    """Phase 17b's one-process reference: LAPGemma3-4B from seed 0, one flow
    request at explicit noise."""
    import torch

    from lap_tpu_torch.models.types import CoTObservation
    from lap_tpu_torch.policies.policy import _stack_batch

    model = config.create_module(device=device, init_seed=0)
    depth = len(model.llm.layers)
    actions = model.sample_actions(CoTObservation.from_dict(_stack_batch([request]), device=device),
                                   noise=torch.from_numpy(noise).to(device)).float().cpu().numpy()
    del model
    release()
    return dict(actions=actions, depth=depth)


def check_tp_gemma3(ranks, ref: dict) -> dict:
    """Phase 17b: tp = 2 flow serving of LAPGemma3-4B at full width (4 query
    and 2 KV heads a rank) against one process's model of the same seed."""
    import numpy as np

    rel = float(np.linalg.norm(ranks[0]["actions"] - ref["actions"]) / np.linalg.norm(ref["actions"]))
    launches = [r["launches"] for r in ranks]
    depth = ref["depth"]
    numbers = dict(rel_err=rel, launches_per_rank=launches, resident_gb_per_rank=[r["resident_gb"] for r in ranks],
                   peak_gb_per_rank=[r["peak_gb"] for r in ranks])
    log(f"parallel 17b: tp={TP_RANKS} LAPGemma3-4B flow request: actions vs one process rel_err={rel:.3e} (tol "
        f"{PATH_REL_TOL}); (flash, int8, int4) launches per rank {launches} (expected {depth} flash); GiB resident a "
        f"rank {[round(r['resident_gb'], 2) for r in ranks]}, peak {[round(r['peak_gb'], 2) for r in ranks]}")
    if rel > PATH_REL_TOL or any(c != (depth, 0, 0) for c in launches):
        raise AssertionError(f"tp gemma3: rel_err {rel} or launches {launches}")
    return numbers


def _train_args(run_dir: Path, exp: str, device: str, *extra) -> list[str]:
    """``train.main``'s command line of phase 17c: the ``lap`` config at full
    width, both experts cut to TRAIN_PHASE_DEPTH layers, fake data."""
    return ["lap", "--exp_name", exp, "--checkpoint_base_dir", str(run_dir), "--data.repo_id", "fake",
            "--data.data_mix", "none", "--batch_size", str(PARALLEL_TRAIN_BATCH), "--save_interval", "100000",
            "--log_interval", "1", "--model.paligemma_variant", f"gemma_2b_depth{TRAIN_PHASE_DEPTH}",
            "--model.action_expert_variant", f"gemma_300m_depth{TRAIN_PHASE_DEPTH}", "--device", device, *extra]


def _register_depth_variants() -> None:
    from lap_tpu_torch.models import gemma

    for base in ("gemma_2b", "gemma_300m"):
        gemma._VARIANTS[f"{base}_depth{TRAIN_PHASE_DEPTH}"] = {**gemma._VARIANTS[base], "depth": TRAIN_PHASE_DEPTH}


@contextlib.contextmanager
def _steps_logged():
    """The (loss, grad_norm) of every step the training loop logs."""
    import logging

    records = []

    class Handler(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("step ") and " val " not in msg:
                fields = dict(kv.split("=", 1) for kv in msg.split()[2:] if "=" in kv)
                records.append((float(fields["loss"]), float(fields["grad_norm"])))

    handler = Handler(level=logging.INFO)
    train_logger = logging.getLogger("lap_tpu_torch.train")
    train_logger.addHandler(handler)
    level = train_logger.level
    train_logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        train_logger.removeHandler(handler)
        train_logger.setLevel(level)


@contextlib.contextmanager
def _no_saves():
    """Runs whose step directory nothing reads write none: the card's host
    stops a call that has written 45 GiB, and one step of the f32 recipe is
    23.6 GB at depth 2."""
    from lap_tpu_torch.training import checkpoints

    save = checkpoints.CheckpointManager.save
    checkpoints.CheckpointManager.save = lambda self, step, state, assets=None: None
    try:
        yield
    finally:
        checkpoints.CheckpointManager.save = save


def gradient_leaves(model, named: dict) -> dict:
    """Per leaf of a step's gradient ``named`` (each rank's shards): its
    squared norm and its projections on GRAD_PROJECTIONS Gaussian directions
    of the whole leaf's shape, seeded by its name, each rank projecting its
    shard on its slice of them (``local_shard``), summed over the ranks that
    hold distinct shards (``counted_once``): the same numbers for any
    placement of the same gradient."""
    import zlib

    import torch
    import torch.distributed as dist

    from lap_tpu_torch.parallel.sharding import counted_once, local, local_shard

    par = getattr(model, "parallel", None)
    rows = []
    with torch.no_grad():
        for name, grad in named.items():
            g = local(grad).float()
            row = torch.zeros(1 + GRAD_PROJECTIONS, dtype=torch.float64, device=g.device)
            if counted_once(model, name):
                shape = par.plan.placements[name].shape if par is not None else tuple(g.shape)
                row[0] = g.square().sum(dtype=torch.float64)
                for j in range(GRAD_PROJECTIONS):
                    gen = torch.Generator(device=g.device).manual_seed(zlib.crc32(f"{name}#{j}".encode()))
                    part = local_shard(model, name, torch.randn(shape, generator=gen, device=g.device))
                    if part.shape != g.shape:
                        raise AssertionError(f"gradient leaf {name}: shard {tuple(g.shape)}, slice {tuple(part.shape)}")
                    row[1 + j] = (g * part).sum(dtype=torch.float64)
            rows.append(row)
        table = torch.stack(rows)
        if par is not None:
            dist.all_reduce(table)
    return dict(zip(named, table.cpu().numpy(), strict=True))


@contextlib.contextmanager
def _first_gradient():
    """``gradient_leaves`` of the first gradient that a training step takes
    the norm of (step 0's: the same parameters in every run of a seed)."""
    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training import train_step

    made, one, sharded = port_train.make_step_functions, train_step.global_norm, train_step.parallel_norm
    out, models = {}, []

    def make(model, *args, **kwargs):
        models.append(model)
        return made(model, *args, **kwargs)

    def one_norm(tensors):
        tensors = list(tensors)
        if "leaves" not in out:
            names = [n for n, p in models[-1].named_parameters() if p.requires_grad]
            out["leaves"] = gradient_leaves(models[-1], dict(zip(names, tensors, strict=True)))
        return one(tensors)

    def sharded_norm(model, named):
        if "leaves" not in out:
            out["leaves"] = gradient_leaves(model, named)
        return sharded(model, named)

    port_train.make_step_functions, train_step.global_norm, train_step.parallel_norm = make, one_norm, sharded_norm
    try:
        yield out
    finally:
        port_train.make_step_functions, train_step.global_norm, train_step.parallel_norm = made, one, sharded


def leaf_differences(got: dict, ref: dict) -> dict:
    """Per gradient leaf: the estimate of ``|g - g_ref|`` (the larger of the
    norms' difference and the projections' root-mean-square difference), the
    reference leaf's norm, and the leaf's bound."""
    import numpy as np

    total = float(np.sqrt(sum(r[0] for r in ref.values())))
    out = {}
    for name, r in ref.items():
        g = got[name]
        norm = float(np.sqrt(r[0]))
        diff = max(abs(float(np.sqrt(g[0])) - norm), float(np.sqrt(np.mean((g[1:] - r[1:]) ** 2))))
        out[name] = (diff, norm, GRAD_LEAF_REL_TOL * norm + GRAD_LEAF_FLOOR * total)
    return out


def _rows_of(observation, rows: slice):
    """The rows ``rows`` of a batched observation, contiguous (as a rank's
    loader gives them)."""
    import dataclasses

    import torch

    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        return v[rows].contiguous() if isinstance(v, torch.Tensor) and v.dim() > 0 else v

    return dataclasses.replace(observation, **{f.name: take(getattr(observation, f.name))
                                               for f in dataclasses.fields(observation)})


def train_job(rank, world, argv, checks):
    """Phase 17c on each rank: ``train.main(argv)`` (the process group is
    up, so it builds the mesh and shards); the logged steps, the first step's
    gradient leaves and this rank's peak memory; with ``checks`` the whole
    state's checksums, the next batch's loss (this rank's share, summed over
    the data ranks) and this rank's loss over its own rows alone."""
    import torch
    import torch.distributed as dist

    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import full_tensor
    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.train_step import _take_rows, step_generator

    _register_depth_variants()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counters()
    t0 = time.monotonic()
    with _steps_logged() as steps, _first_gradient() as first, (contextlib.nullcontext() if checks else _no_saves()):
        run = port_train.main(argv)
    result = dict(steps=steps, seconds=time.monotonic() - t0, launches=flash_and_backward_launches(),
                  peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                  mesh=mesh_lib.mesh_shape(run.trainer.model.parallel.mesh), leaves=first["leaves"])
    if checks:
        state, model = run.trainer.state, run.trainer.model
        result["checksums"] = state_checksums(state, whole=lambda n, t: full_tensor(model, n, t))
        result["write_bytes"] = (run.checkpoints.last_save or {}).get("bytes")
        observation, actions = next(run.data_iter)
        par = model.parallel
        _, count = par.data_placement
        rows = actions.shape[0] * count
        gen = step_generator(run.trainer.config.seed, state.step, model.device)
        draws = _take_rows(model.loss_randomness(rows, gen), mesh_lib.data_sharding(par.mesh, rows))
        with torch.no_grad():
            with par.scope():
                loss, _ = model.compute_loss(observation, actions, train=True, **draws)
            # Outside the mesh's scope the loss is the mean over this rank's
            # rows alone (FSDP still gathers the parameters).
            own, _ = model.compute_loss(observation, actions, train=True, **draws)
        total = loss.detach().to(torch.float64)
        dist.all_reduce(total, group=mesh_lib.data_group(par.mesh))
        result["next_loss"] = float(total)
        result["own_rows_loss"] = own.item()
    run.close()
    keep = ("peak_gb", "launches", "own_rows_loss")
    return result if rank == 0 else {k: v for k, v in result.items() if k in keep}


def run_parallel_training(device) -> dict:
    """Phases 17b and 17c. 17b: tp = 2 LAPGemma3-4B flow serving. 17c:
    ``train.main`` at ``lap``'s full width (both experts cut to
    TRAIN_PHASE_DEPTH layers) with the recipe's f32 parameters, AdamW and
    EMA, global batch PARALLEL_TRAIN_BATCH, PARALLEL_TRAIN_STEPS steps: in
    one process, on a 1-rank NCCL world, at --fsdp_devices 2 and at
    --tp_devices 2 --sequence_parallel true (two gloo ranks on one card),
    each held to one process by its losses, grad norms and the first step's
    gradient leaves; then a step directory written under FSDP (phase 13's
    bf16 and frozen VLM, for the disk budget) restored into one process.
    The two-rank runs of 17b and 17c share one spawned world."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from lap_tpu_torch.training import train as port_train
    from lap_tpu_torch.training.config import get_config
    from lap_tpu_torch.training.train_step import _take_rows, step_generator

    t_phase = time.monotonic()
    g3_config = dataclasses.replace(get_config(G3_CONFIG).model, stop_action_to_vlm_grad=False)
    g3_request_, g3_noise = g3_request(0, g3_config), tp_gemma3_noise(g3_config)
    _register_depth_variants()
    run_dir = Path(tempfile.mkdtemp(prefix=".train_phase_", dir=REPO))
    numbers = {}
    steps = str(PARALLEL_TRAIN_STEPS)
    recipe = ("--num_train_steps", steps, "--param_dtype", PARALLEL_TRAIN_DTYPE)
    runs = {
        "nccl_1_rank": (1, SINGLE_RANK_BACKEND, []),
        "fsdp2": (TP_RANKS, PARALLEL_BACKEND, ["--fsdp_devices", str(TP_RANKS)]),
        "tp2_sp": (TP_RANKS, PARALLEL_BACKEND, ["--tp_devices", str(TP_RANKS), "--sequence_parallel", "true"]),
    }
    # The two-rank world: 17b, the two sharded comparisons, the FSDP save.
    small = ("--num_train_steps", "1", "--param_dtype", TRAIN_PHASE_DTYPE, "--freeze_vlm", TRAIN_PHASE_FREEZE_VLM)
    jobs = [("tp_gemma3_job", (g3_request_, g3_noise, PARALLEL_DEVICE))]
    jobs += [("train_job", (_train_args(run_dir, name, PARALLEL_DEVICE, *recipe, *runs[name][2]), False))
             for name in ("fsdp2", "tp2_sp")]
    jobs.append(("train_job", (_train_args(run_dir, "fsdp_saved", PARALLEL_DEVICE, *small, "--fsdp_devices",
                                           str(TP_RANKS)), True)))
    # Both worlds start up while this process runs the references.
    try:
        with parallel_world(1, SINGLE_RANK_BACKEND, "train_job",
                            _train_args(run_dir, "nccl_1_rank", PARALLEL_DEVICE, *recipe), False) as nccl_world, \
                parallel_world(TP_RANKS, PARALLEL_BACKEND, "jobs_in_turn", jobs) as shared_world:
            g3_ref = tp_gemma3_reference(g3_config, g3_request_, g3_noise, device)
            release()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            with _steps_logged() as ref, _first_gradient() as first, _no_saves():
                port_train.main(_train_args(run_dir, "one_process", str(device), *recipe)).close()
            release()
            ref_leaves = first["leaves"]
            numbers["one_process"] = dict(steps=ref, seconds=time.monotonic() - t0,
                                          peak_gb=torch.cuda.max_memory_allocated() / 2**30)
            got_runs = {"nccl_1_rank": nccl_world()}
            t0 = time.monotonic()
            by_rank = shared_world()
            world_s = time.monotonic() - t0
        by_job = [[by_rank[r][j] for r in range(TP_RANKS)] for j in range(len(jobs))]
        numbers["tp_gemma3"] = check_tp_gemma3(by_job[0], g3_ref)
        got_runs.update(fsdp2=by_job[1], tp2_sp=by_job[2])
        failed = []  # every run is logged before the phase fails
        for name, (world, backend, _) in runs.items():
            ranks = got_runs[name]
            got = ranks[0]
            loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got["steps"], ref, strict=True)]
            norm_rel = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got["steps"], ref, strict=True)]
            leaves = leaf_differences(got["leaves"], ref_leaves)
            over = sorted(n for n, (d, _, bound) in leaves.items() if d > bound)
            worst = sorted(leaves, key=lambda n: leaves[n][0] / leaves[n][2], reverse=True)[:3]
            rel = {n: d / norm for n, (d, norm, _) in leaves.items() if norm > 0}
            rel_worst = sorted(rel, key=rel.get, reverse=True)[:3]
            numbers[name] = dict(backend=backend, mesh=got["mesh"], steps=got["steps"], loss_rel=loss_rel,
                                 grad_norm_rel=norm_rel, peak_gb_per_rank=[r["peak_gb"] for r in ranks],
                                 launches_per_rank=[r["launches"] for r in ranks], seconds=got["seconds"],
                                 grad_leaves=len(leaves), grad_leaves_over_bound=over,
                                 grad_leaf_worst={n: dict(diff=leaves[n][0], norm=leaves[n][1], bound=leaves[n][2])
                                                  for n in worst},
                                 grad_leaf_rel_worst={n: rel[n] for n in rel_worst})
            log(f"parallel 17c: {name} ({world} rank(s), {backend}, mesh {got['mesh']}): (loss, grad_norm) a step "
                f"{got['steps']} vs one process {ref}: loss rel {[f'{x:.2e}' for x in loss_rel]} (tol "
                f"{PARALLEL_LOSS_REL_TOL}), grad_norm rel {[f'{x:.2e}' for x in norm_rel]} (tol "
                f"{PARALLEL_GRAD_NORM_REL_TOL}); the first step's {len(leaves)} gradient leaves: {len(over)} over "
                f"their bound ({GRAD_LEAF_REL_TOL} of the leaf's norm + {GRAD_LEAF_FLOOR} of the whole gradient's), "
                f"the nearest to it " + ", ".join(f"{n} {leaves[n][0]:.3e} of {leaves[n][1]:.3e} (bound "
                                                   f"{leaves[n][2]:.3e})" for n in worst)
                + "; the largest relative to their norm " + ", ".join(f"{n} {rel[n]:.2e}" for n in rel_worst)
                + f"; peak GiB a rank {[round(r['peak_gb'], 2) for r in ranks]}; (fwd, dq, dkv, delta, group_sum) "
                f"launches a rank {[r['launches'] for r in ranks]}; {got['seconds']:.1f} s")
            if len(got["steps"]) != PARALLEL_TRAIN_STEPS or max(loss_rel) > PARALLEL_LOSS_REL_TOL \
                    or max(norm_rel) > PARALLEL_GRAD_NORM_REL_TOL or over:
                failed.append(f"parallel training {name}: losses, grad norms or gradient leaves {over[:5]} off the "
                              f"one-process run")
        # The step directory written under FSDP, restored into one process:
        # every state tensor and each data rank's loss over its own rows
        # (the same rows, draws and shapes) bit-equal.
        saved = by_job[3]
        restored = port_train.main(_train_args(run_dir, "fsdp_saved", str(device), *small, "--resume", "true"))
        state, model = restored.trainer.state, restored.trainer.model
        sums = state_checksums(state)
        differ = sorted(k for k in saved[0]["checksums"] if sums.get(k) != saved[0]["checksums"][k])
        observation, actions = next(restored.data_iter)
        rows = actions.shape[0]
        gen = step_generator(restored.trainer.config.seed, state.step, device)
        draws = model.loss_randomness(rows, gen)
        own = []
        with torch.no_grad():
            loss, _ = model.compute_loss(observation, actions, train=True, **draws)
            for r in range(TP_RANKS):
                part = slice(r, rows, TP_RANKS)
                own.append(model.compute_loss(_rows_of(observation, part), actions[part].contiguous(), train=True,
                                              **_take_rows(draws, part))[0].item())
        next_loss = loss.item()
        restored.close()
        own_sharded = [r["own_rows_loss"] for r in saved]
        next_rel = abs(next_loss - saved[0]["next_loss"]) / abs(saved[0]["next_loss"])
        numbers["restore"] = dict(tensors=len(sums) - 2, differ=len(differ), write_bytes=saved[0]["write_bytes"],
                                  own_rows_loss_sharded=own_sharded, own_rows_loss_one_process=own,
                                  next_loss_sharded=saved[0]["next_loss"], next_loss_one_process=next_loss,
                                  next_loss_rel=next_rel)
        log(f"parallel 17c: the FSDP step directory ({saved[0]['write_bytes']} bytes written, {TRAIN_PHASE_DTYPE}, "
            f"--freeze_vlm {TRAIN_PHASE_FREEZE_VLM}) restored into one process: {len(sums) - 2 - len(differ)} of "
            f"{len(sums) - 2} state tensors bit-equal to the sharded run's whole tensors; the next batch's loss over "
            f"each data rank's rows {own!r} vs the ranks' own {own_sharded!r} (bit-equal: "
            f"{own == own_sharded}); over the whole batch {next_loss!r} vs the sum of the ranks' shares "
            f"{saved[0]['next_loss']!r} (rel {next_rel:.2e}: 8-row against 4-row bf16 matmuls; tol "
            f"{PARALLEL_LOSS_REL_TOL}); the two-rank world took {world_s:.1f} s")
        if differ or own != own_sharded or next_rel > PARALLEL_LOSS_REL_TOL:
            failed.append(f"parallel restore: {len(differ)} tensors differ (first {differ[:3]}), the losses over each "
                          f"rank's rows {own} vs {own_sharded}, next loss rel {next_rel}")
        if failed:
            raise AssertionError("; ".join(failed))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    numbers["seconds"] = time.monotonic() - t_phase
    return numbers


def plan_large_models() -> dict:
    """Phase 17d: ``fsdp_sharding(..., log=True)`` of lap_gemma3_12b and
    lap_gemma3_27b on the meta device at (fsdp 4) and (fsdp 2, tp 2): bytes a
    rank holds. No memory is allocated."""
    import logging

    from lap_tpu_torch.parallel.sharding import fsdp_sharding
    from lap_tpu_torch.training.config import get_config

    logging.getLogger("lap_tpu_torch.parallel.sharding").setLevel(logging.WARNING)  # the per-leaf lines
    out = {}
    for name in PLANNED_CONFIGS:
        model = get_config(name).model.create_module(device="meta", init_seed=None,
                                                     param_dtype=getattr(__import__("torch"), "float32"))
        total = sum(p.numel() * p.element_size() for p in model.parameters())
        for mesh in PLANNED_MESHES:
            plan = fsdp_sharding(model, mesh, log=True)
            key = f"{name} {mesh}"
            out[key] = dict(total_gb=total / 1e9, per_rank_gb=plan.per_rank_bytes / 1e9,
                            sharded_gb=plan.sharded_bytes / 1e9, replicated_gb=plan.replicated_bytes / 1e9,
                            sharded=plan.num_sharded, replicated=plan.num_replicated)
            log(f"parallel 17d: {key}: f32 parameters {total / 1e9:.2f} GB; JAX's placement shards "
                f"{plan.num_sharded} leaves ({plan.sharded_bytes / 1e9:.2f} GB) and replicates {plan.num_replicated} "
                f"({plan.replicated_bytes / 1e9:.3f} GB): {plan.per_rank_bytes / 1e9:.2f} GB of parameters a rank")
        del model
    return out


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
    stack = run_serving_stack(model, config, device)
    check_ar_kernels_against_plain(model, config, device)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = run_training(device)
    release()
    entry = run_train_entry_points(device)
    bwd_timing = time_flash_backward(device, TRAIN_BATCH)
    check_small_gemma3_reference(device)
    g3 = run_gemma3_serving(device)
    g3_train = run_gemma3_training(device)
    g3_fwd_timing = time_gemma3_flash_forward(device)
    g3_bwd_timing = time_flash_backward(device, TRAIN_BATCH, gemma3=True)
    print(json.dumps({"gemma3": {**g3, "training": g3_train}}), flush=True)
    g3_flash, g3_int8, g3_int4 = (g3["launches"][k] for k in ("flash", "int8", "int4"))
    variants = run_variants(device)
    variant_fwd_timing = time_variant_flash_forward(device)
    release()
    rlds = run_rlds_training(device)
    release()
    t17 = time.monotonic()
    tp_serving = stack["parallel"]
    par_train = run_parallel_training(device)
    tp_g3 = par_train.pop("tp_gemma3")
    plans = plan_large_models()
    par_bwd = dict(fwd=0, dq=0, dkv=0, delta=0, group_sum=0)
    for name in ("nccl_1_rank", "fsdp2", "tp2_sp"):
        for counts in par_train[name]["launches_per_rank"]:
            for key, n in zip(par_bwd, counts, strict=True):
                par_bwd[key] += n
    par_bwd["fwd"] += tp_serving["flash_launches"] + sum(c[0] for c in tp_g3["launches_per_rank"])
    print(json.dumps({"parallel": {"serving": tp_serving, "gemma3": tp_g3, "training": par_train, "plans": plans,
                                   "launches": par_bwd, "seconds_17bcd": time.monotonic() - t17}}), flush=True)
    log(f"parallel: phase 17b-d took {time.monotonic() - t17:.1f} s, 17a {tp_serving['seconds']:.1f} s")

    csrc = "lap_tpu_torch/csrc/"
    kernels = [
        dict(
            name="flash_attention_fwd", route="cuda", source=csrc + fa.SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:53",
            launches=flow_launches + sum(c[0] for c in quant_flow.values()) + sum(c[0] for c in ar.values())
            + stack["flash"] + train_launches["fwd"] + entry["fwd"] + g3_flash + g3_train["launches"]["fwd"]
            + variants["fwd"] + rlds["fwd"] + par_bwd["fwd"], launches_parallel=par_bwd["fwd"],
            launches_gemma3_serving=g3_flash, launches_gemma3_training=g3_train["launches"]["fwd"],
            launches_variants=variants["fwd"], launches_rlds_training=rlds["fwd"], variant_prefills=variant_fwd_timing,
            launches_flow=flow_launches, launches_quant_flow=sum(c[0] for c in quant_flow.values()),
            launches_ar=sum(c[0] for c in ar.values()), launches_serving_stack=stack["flash"],
            launches_training=train_launches["fwd"], launches_train_entry_points=entry["fwd"],
            max_abs_err=max(max_err, bwd_err["fwd"]), **timing,
            timed_at=f"B=1 T=S={LAP_PREFIX} (serving prefill)",
            training_shape={k: v for k, v in bwd_timing["fwd"].items() if k != "batch"},
            gemma3_prefill=g3_fwd_timing,
            gemma3_training_shape={k: v for k, v in g3_bwd_timing["fwd"].items() if k != "batch"},
            occupancy=fwd_occupancy,
        ),
        dict(
            name="flash_attention_bwd_dq", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:173",
            launches=train_launches["dq"] + entry["dq"] + g3_train["launches"]["dq"] + variants["dq"]
            + rlds["dq"] + par_bwd["dq"], launches_parallel=par_bwd["dq"],
            launches_variants=variants["dq"], launches_rlds_training=rlds["dq"],
            launches_training=train_launches["dq"], launches_train_entry_points=entry["dq"],
            launches_gemma3_training=g3_train["launches"]["dq"],
            gemma3_training_shape={k: v for k, v in g3_bwd_timing["dq"].items() if k != "batch"},
            max_abs_err=bwd_err["dq"], **bwd_timing["dq"],
        ),
        dict(
            name="flash_attention_bwd_dkv", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:215",
            launches=train_launches["dkv"] + entry["dkv"] + g3_train["launches"]["dkv"] + variants["dkv"]
            + rlds["dkv"] + par_bwd["dkv"], launches_parallel=par_bwd["dkv"],
            launches_variants=variants["dkv"], launches_rlds_training=rlds["dkv"],
            launches_training=train_launches["dkv"], launches_train_entry_points=entry["dkv"],
            launches_gemma3_training=g3_train["launches"]["dkv"],
            gemma3_training_shape={k: v for k, v in g3_bwd_timing["dkv"].items() if k != "batch"},
            max_abs_err=bwd_err["dkv"], **bwd_timing["dkv"],
        ),
        dict(
            name="flash_attention_bwd_delta", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:270",
            launches=train_launches["delta"] + entry["delta"] + g3_train["launches"]["delta"] + variants["delta"]
            + rlds["delta"] + par_bwd["delta"], launches_parallel=par_bwd["delta"],
            launches_variants=variants["delta"], launches_rlds_training=rlds["delta"],
            launches_training=train_launches["delta"], launches_train_entry_points=entry["delta"],
            launches_gemma3_training=g3_train["launches"]["delta"],
            gemma3_training_shape={k: v for k, v in g3_bwd_timing["delta"].items() if k != "batch"},
            max_abs_err=bwd_err["delta"], **bwd_timing["delta"],
        ),
        dict(
            name="flash_attention_bwd_group_sum", route="cuda", source=csrc + fa.BWD_SOURCE,
            replaces="lap_tpu/ops/flash_attention.py:340",
            launches=train_launches["group_sum"] + entry["group_sum"] + g3_train["launches"]["group_sum"]
            + variants["group_sum"] + rlds["group_sum"] + par_bwd["group_sum"], launches_parallel=par_bwd["group_sum"],
            launches_variants=variants["group_sum"], launches_rlds_training=rlds["group_sum"],
            launches_training=train_launches["group_sum"], launches_train_entry_points=entry["group_sum"],
            launches_gemma3_training=g3_train["launches"]["group_sum"],
            gemma3_training_shape={k: v for k, v in g3_bwd_timing["group_sum"].items() if k != "batch"},
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
            launches=quant_flow[name[:4]][1 + index] + ar[name[:4]][1 + index] + stack.get(name[:4], 0)
            + entry.get(name[:4], 0) + (g3_int8, g3_int4)[index] + variants[name[:4]],
            launches_gemma3=(g3_int8, g3_int4)[index], launches_variants=variants[name[:4]],
            gemma3={f"{shape}_M{m}": t for (shape, m), t in quant_timing[name].items() if shape.startswith("g3_")},
            launches_train_entry_points=entry.get(name[:4], 0),
            launches_quant_flow=quant_flow[name[:4]][1 + index], launches_ar=ar[name[:4]][1 + index],
            launches_serving_stack=stack.get(name[:4], 0),
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
