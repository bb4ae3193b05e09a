"""Policy server entry point (port of ``scripts/serve_policy.py``).

Environment presets (LAP / LAP_AR / LAP_LIBERO / DEBUG) with default
checkpoint directories, optional micro-batching and request recording, and a
websocket server on 0.0.0.0:8000. ``create_policy(args)`` builds the served
policy (restored from ``--checkpoint_dir``, wrapped in ``BatchingPolicy``
with ``--max_batch`` > 1 and in ``PolicyRecorder`` with ``--record_dir``);
``main`` adds the websocket server, whose ``websockets`` and ``msgpack``
imports happen only there. Runs on the card unless ``--device cpu`` is given.

``--serve_tp N`` serves one model split over N cards (tensor parallelism):
the command starts its N ranks itself (one process a card, ``cuda:{rank}``),
or, under ``torchrun``, is one of them. Every rank restores its slices of
the checkpoint; rank 0 runs the server, the others follow its model calls
(``policy.serve_followers``) until it stops.

Usage:
    python -m lap_tpu_torch.serving.serve_policy --env LAP_LIBERO --checkpoint_dir ckpts/... [--port 8000]
    python -m lap_tpu_torch.serving.serve_policy --env LAP --checkpoint_dir ckpts/... --serve_tp 2
    python -m lap_tpu_torch.serving.serve_policy --env DEBUG --device cpu   # tiny random model
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import logging
import sys


class EnvMode(enum.Enum):
    LAP = "LAP"
    LAP_AR = "LAP_AR"
    LAP_LIBERO = "LAP_LIBERO"
    DEBUG = "DEBUG"


@dataclasses.dataclass
class Preset:
    config_name: str
    checkpoint_dir: str
    ar: bool = False
    default_prompt: str | None = None


PRESETS = {
    EnvMode.LAP: Preset("lap", "checkpoints/lap/params_latest"),
    EnvMode.LAP_AR: Preset("lap", "checkpoints/lap/params_latest", ar=True),
    EnvMode.LAP_LIBERO: Preset("lap_libero", "checkpoints/lap_libero/params_latest"),
    EnvMode.DEBUG: Preset("debug", ""),
}


def _create_model_policy(args, device):
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.training import config as _config

    preset = PRESETS[EnvMode(args.env)]
    train_config = _config.get_config(args.config or preset.config_name)
    checkpoint_dir = args.checkpoint_dir or preset.checkpoint_dir
    ar = args.ar if args.ar is not None else preset.ar

    if EnvMode(args.env) == EnvMode.DEBUG and not checkpoint_dir:
        # Randomly initialized tiny policy for pipeline debugging. This
        # branch skips the checkpoint restore, so restore-time features must
        # not be silently ignored.
        if args.serve_tp > 1 or args.quantize:
            raise SystemExit(
                "--serve_tp/--quantize act at checkpoint restore; the DEBUG "
                "preset without --checkpoint_dir never restores. Fabricate a "
                "checkpoint and pass --checkpoint_dir to exercise them."
            )
        from lap_tpu_torch.policies.policy import Policy

        model = train_config.model.create_module(device=device, init_seed=0)
        inputs, outputs = policy_config._build_transform_stacks(
            train_config, None, default_prompt=args.default_prompt, ar=False
        )
        return Policy(
            model, input_transforms=inputs, output_transforms=outputs,
            num_steps=2, token_bucket=args.token_bucket,
            metadata={"config": "debug", "mode": "flow"},
        )

    kw = dict(
        default_prompt=args.default_prompt, allow_test_vocab=args.allow_test_vocab, quantize=args.quantize,
        tp=args.serve_tp, token_bucket=args.token_bucket, device=device,
    )
    if ar:
        return policy_config.create_trained_policy_ar(train_config, checkpoint_dir, **kw)
    return policy_config.create_trained_policy(train_config, checkpoint_dir, **kw)


def create_policy(args):
    """The served policy for parsed ``args``: the restored model's policy,
    behind ``BatchingPolicy`` with ``--max_batch`` > 1, and behind
    ``PolicyRecorder`` with ``--record_dir``."""
    from lap_tpu_torch.device import resolve_device

    policy = _create_model_policy(args, resolve_device(args.device))
    if args.max_batch > 1:
        from lap_tpu_torch.policies.batching import BatchingPolicy

        policy = BatchingPolicy(policy, max_batch=args.max_batch, window_ms=args.batch_window_ms)
    if args.record_dir:
        from lap_tpu_torch.policies.policy import PolicyRecorder

        policy = PolicyRecorder(policy, args.record_dir)
    return policy


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--env", default="LAP", choices=[e.value for e in EnvMode])
    parser.add_argument("--config", default=None, help="override config name")
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--default_prompt", default=None)
    parser.add_argument("--ar", action=argparse.BooleanOptionalAction, default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--record_dir", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device; the card (cuda) unless given, and without one the server refuses to start",
    )
    parser.add_argument(
        "--quantize", default=None, choices=["int8", "int4"],
        help="weight-only quantization on the decode path (prefill stays "
        "bf16): int8 or int4 copies of the decode weights, through the "
        "dequant-matmul kernels on calls of at most 128 rows",
    )
    parser.add_argument(
        "--token_bucket", type=int, default=None,
        help="prompt-length bucketing: trim trailing token padding to the "
        "next multiple of N before prefill (the tokenizer pads to "
        "max_token_len). Unset = reference behavior",
    )
    parser.add_argument(
        "--serve_tp", type=int, default=1,
        help="tensor-parallel serving over N cards, one process a card (started here unless under torchrun). "
        "1 = single card",
    )
    parser.add_argument(
        "--max_batch", type=int, default=1,
        help="serve up to N concurrent robots per batched model call. "
        "1 = reference behavior, no batching layer",
    )
    parser.add_argument(
        "--batch_window_ms", type=float, default=5.0,
        help="after a request arrives, wait this long for companions "
        "before launching the batch (only with --max_batch > 1)",
    )
    parser.add_argument(
        "--allow_test_vocab", action="store_true",
        help="serve a checkpoint through the built-in test vocabulary "
        "(ONLY for fabricated test checkpoints; real checkpoints need "
        "LAP_TPU_TOKENIZER_MODEL)",
    )
    return parser.parse_args(argv)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawned_rank(rank: int, argv: list[str] | None, env: dict) -> None:
    import os

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    main(argv)


def serve(args) -> None:
    """One rank of the server: rank 0 (or a single process) serves on the
    websocket; with ``--serve_tp`` > 1 the other ranks follow its model
    calls until it stops."""
    from lap_tpu_torch.policies.policy import serve_followers, stop_followers

    rank = 0
    if args.serve_tp > 1:
        from lap_tpu_torch.parallel.mesh import init_distributed

        rank, world = init_distributed(device=args.device)
        if world != args.serve_tp:
            raise SystemExit(f"--serve_tp {args.serve_tp} needs a process group of {args.serve_tp} ranks, got {world}")
    policy = create_policy(args)
    if rank != 0:
        logging.info("rank %d: following rank 0's model calls", rank)
        serve_followers(policy)
        return

    from lap_tpu_torch.serving.websocket_policy_server import WebsocketPolicyServer

    logging.info("serving %s on %s:%d", policy.metadata, args.host, args.port)
    try:
        WebsocketPolicyServer(policy, host=args.host, port=args.port).serve_forever()
    finally:
        stop_followers(policy)


def main(argv: list[str] | None = None) -> None:
    import os

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.serve_tp > 1 and "WORLD_SIZE" not in os.environ:
        # Start the ranks here: one process each, rank r on cuda:r.
        import torch.multiprocessing as mp

        env = dict(WORLD_SIZE=str(args.serve_tp), LOCAL_WORLD_SIZE=str(args.serve_tp), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()))
        mp.start_processes(_spawned_rank, args=(argv, env), nprocs=args.serve_tp, start_method="spawn")
        return
    serve(args)


if __name__ == "__main__":
    main()
