#!/usr/bin/env python3
"""Time the flash-attention forward kernel of one checkout on one NVIDIA GPU.

    python3 scripts/time_flash_forward.py [--repo DIR] [--label NAME]

Builds the checkout's forward kernel from its ``lap_tpu_torch/csrc/`` and
times ``flash_attention_forward`` at the two shapes the paths give it: the LAP-3B serving prefill
(B=1, T=S=692, the flow prefix mask: 552 live tokens) and the training call
(B=8, q and the mask the first 692 rows of 708-row tensors, S=708), each
beside ``F.scaled_dot_product_attention`` on the same inputs (a yardstick
only) and the bound (``chip_smoke.flash_forward_bound``). The inputs, the
timers and the bound come from this script's own ``chip_smoke.py``, so two
checkouts are timed the same way. To compare two checkouts on one card, run
this script for each in one command, in turns (A B B A); ``--repo`` points
at the other checkout (an unpacked ``git archive`` of it). Three times:
CUDA events around a loop of 50 calls (``ms``, median of 5 runs, the way
``chip_smoke.py`` reports ``ms``), which is the host's time when the host
takes longer to launch a call than the card to run it; the device time of
the call's kernels from the profiler (``device_ms``); and the host's time to
launch one call (``host_ms``: 200 calls on the host clock with no
synchronisation in between, fewer than the launch queue holds; median of 5
runs). The plain version (``flash_attention_plain``) by CUDA events beside
them (``plain_ms``). Prints one JSON line per shape, then the card's name
and power limit. Imports nothing of JAX. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(HERE), help="root of the checkout whose kernel is timed")
    parser.add_argument("--label", default="", help="name printed with every line")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    if not (repo / "lap_tpu_torch" / "csrc").is_dir():
        print(f"no checkout of the port at {repo}", file=sys.stderr)
        return 1
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))  # the checkout's lap_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    from lap_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(2)
    n, kh, h = 8, 1, 256
    prefill_t = chip_smoke.LAP_PREFIX
    train_b, train_s = chip_smoke.TRAIN_BATCH, chip_smoke.LAP_PREFIX + chip_smoke.ACTION_HORIZON
    shapes = {
        "prefill": (chip_smoke.prefix_lm_mask([512 + chip_smoke.PROMPT_VALID], [0], prefill_t, device),
                    torch.randn((1, prefill_t, n, h), generator=g, device=device).to(torch.bfloat16), prefill_t),
        "training": (chip_smoke.training_mask(train_b, device), chip_smoke.training_queries(train_b, g, device),
                     train_s),
    }
    for name, (mask, q, s) in shapes.items():
        b = q.shape[0]
        k = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, kh, h), generator=g, device=device).to(torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        times = {}
        for key, fn in (("", lambda: fa.flash_attention_forward(q, k, v, mask)),
                        ("library_", lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                                                             enable_gqa=True))):
            times[key + "ms"] = chip_smoke.time_cuda(fn)
            times[key + "device_ms"] = chip_smoke.device_ms_per_call([fn], iters=50)
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host.append((time.perf_counter() - t0) / 200 * 1e3)
            times[key + "host_ms"] = statistics.median(host)
            torch.cuda.synchronize()
        times["plain_ms"] = chip_smoke.time_cuda(lambda: fa.flash_attention_plain(q, k, v, mask), iters=5, reps=3)
        bound_ms, bound_by, _, _ = chip_smoke.flash_forward_bound(mask, q, k, v)
        print(json.dumps({"label": args.label, "shape": name, "B": b, "T": q.shape[1], "S": s, **times,
                          "bound_ms": bound_ms, "bound_by": bound_by}), flush=True)
    print(chip_smoke.gpu_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
