"""Export a JAX checkpoint's params to a flat ``.npz`` the PyTorch port reads.

    python scripts/export_jax_params.py CHECKPOINT/STEP/params [--out FILE]

Reads an orbax ``params/`` directory (what ``lap_tpu``'s CheckpointManager
writes as ``{step}/params``, or a released checkpoint's) with
``lap_tpu.training.checkpoints.restore_params`` and writes every leaf to an
``.npz`` under the key ``params/<path>`` (``params/llm/layers/attn/q_einsum/w``,
...). bfloat16 leaves are stored as 2-byte void, as ``np.save`` stores them
without ``ml_dtypes``. The default output is ``params.npz`` inside the params
directory, where ``lap_tpu_torch``'s ``create_trained_policy`` and the
``checkpoint`` weight loader look for it.

This tool imports JAX and orbax; ``lap_tpu_torch`` reads only its output
(orbax writes through tensorstore, which the port's hosts need not have).
"""

from __future__ import annotations

# Allow `python scripts/...` straight from a checkout: put the repo root on
# sys.path without requiring an installed package.
import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

OUT_FILE = "params.npz"


def flat_leaves(tree: dict, parent: str = "params") -> dict:
    """Nested dict -> {"params/a/b": numpy array}; bfloat16 as 2-byte void."""
    out = {}
    for key, value in tree.items():
        path = f"{parent}/{key}"
        if isinstance(value, dict):
            out.update(flat_leaves(value, path))
        elif value is not None:
            arr = np.asarray(value)
            out[path] = arr.view(np.dtype("V2")) if arr.dtype.name == "bfloat16" else arr
    return out


def export(params_dir: str | Path, out: str | Path | None = None) -> Path:
    """Write the params of an orbax ``params_dir`` to ``out`` (default
    ``params_dir/params.npz``); returns the output path."""
    from lap_tpu.training.checkpoints import restore_params

    params_dir = Path(params_dir)
    out = Path(out) if out is not None else params_dir / OUT_FILE
    leaves = flat_leaves(restore_params(params_dir))
    tmp = out.with_name(out.name + ".tmp")
    with tmp.open("wb") as f:
        np.savez(f, **leaves)
    tmp.replace(out)
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("params_dir", help="an orbax params/ directory ({checkpoint}/{step}/params)")
    parser.add_argument("--out", default=None, help=f"output .npz (default: PARAMS_DIR/{OUT_FILE})")
    args = parser.parse_args(argv)
    path = export(args.params_dir, args.out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
