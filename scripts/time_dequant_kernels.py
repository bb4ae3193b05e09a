#!/usr/bin/env python3
"""Time the int8 and int4 dequant kernels of one checkout on one NVIDIA GPU.

    python3 scripts/time_dequant_kernels.py [--repo DIR] [--label NAME]

Builds the checkout's kernels from its ``lap_tpu_torch/csrc/`` and runs its
``chip_smoke.time_quant_kernels``: device time per call with cold L2 at the
shapes that checkout times, beside the bound, the plain version and
``torch.matmul`` on the bf16 weight. To compare two checkouts on one card,
run this script for each in one command, in turns (A B B A); ``--repo``
points at the other checkout (an unpacked ``git archive`` of it). Prints
one JSON line per (kernel, shape, rows), then the card's name and power
limit. Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]),
                        help="root of the checkout whose kernels are timed")
    parser.add_argument("--label", default="", help="name printed with every line")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    if not (repo / "chip_smoke.py").is_file() or not (repo / "lap_tpu_torch" / "csrc").is_dir():
        print(f"no checkout of the port at {repo}", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    timing = chip_smoke.time_quant_kernels(torch.device("cuda"))
    for kernel, rows in timing.items():
        for (shape, m), times in rows.items():
            print(json.dumps({"label": args.label, "kernel": kernel, "shape": shape, "rows": m, **times}), flush=True)
    print(chip_smoke.gpu_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
