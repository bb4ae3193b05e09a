"""Trainer entry point (port of the core loop of ``scripts/train.py``).

    python -m lap_tpu_torch.training.train lap --num_train_steps 10 --batch_size 8

Builds the configured model from a seed, draws one synthetic batch (prompt
tokens ``arange(max_token_len)``, a language-action span from token 8, loss
mask all true, random uint8 images, seeded non-zero actions) and takes
optimizer steps on it, logging loss, gradient norm and step time. It runs on
the card unless ``--device cpu`` is given. Checkpoints, the data loader, wandb,
meshes and preemption handling are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from lap_tpu_torch.device import resolve_device
from lap_tpu_torch.models.lap_model import LAP, LAPConfig, get_vlm_freeze_filter
from lap_tpu_torch.training.config import TrainConfig, get_config
from lap_tpu_torch.training.state import TrainState
from lap_tpu_torch.training.train_step import StepFunctions, make_step_functions

logger = logging.getLogger("lap_tpu_torch.train")

LANGACT_START = 8  # first language-action token of the synthetic prompt


def fake_train_batch(cfg: LAPConfig, batch: int, *, device, seed: int = 0):
    """The synthetic training batch: (observation, actions)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h, w = cfg.image_resolution
    t = cfg.max_token_len
    obs = cfg.fake_obs(batch, device=device)
    images = {
        k: torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, generator=gen).to(device)
        for k in cfg.image_keys
    }
    obs = obs.replace(
        images=images,
        tokenized_prompt=torch.arange(t, dtype=torch.int32, device=device).expand(batch, t).contiguous(),
        tokenized_langact_mask=(torch.arange(t, device=device) >= LANGACT_START).expand(batch, t).contiguous(),
        token_loss_mask=torch.ones((batch, t), dtype=torch.bool, device=device),
    )
    actions = torch.randn((batch, cfg.action_horizon, cfg.action_dim), generator=gen).to(device)
    return obs, actions


@dataclasses.dataclass
class Trainer:
    """A built model with its step functions, state and random generator."""

    config: TrainConfig
    model: LAP
    steps: StepFunctions
    state: TrainState
    generator: torch.Generator

    def run(self, batch, num_steps: int) -> list[dict]:
        """Take ``num_steps`` optimizer steps on ``batch``; returns one record
        per step (loss, grad_norm, param_norm, step_ms)."""
        records = []
        for i in range(num_steps):
            t0 = time.monotonic()
            self.state, metrics = self.steps.train_step(self.state, batch, generator=self.generator)
            record = {k: float(metrics[k]) for k in ("loss", "grad_norm", "param_norm")}  # syncs the device
            record["step_ms"] = (time.monotonic() - t0) * 1e3
            records.append(record)
            step = self.state.step
            if i == 0 or step % self.config.log_interval == 0 or i == num_steps - 1:
                logger.info("step %d loss %.4f grad_norm %.4f step_ms %.1f",
                            step, record["loss"], record["grad_norm"], record["step_ms"])
        return records


def build_trainer(config: TrainConfig, *, device=None, param_dtype: str | None = None) -> Trainer:
    """The configured model from the config's seed, on the card unless
    ``device`` says otherwise, with its optimizer state and EMA."""
    device = resolve_device(device)
    dtype = getattr(torch, param_dtype or config.param_dtype)
    model = LAP(config.model, device=device, init_seed=config.seed, param_dtype=dtype)
    steps = make_step_functions(
        model,
        config.optimizer,
        config.lr_schedule,
        ema_decay_for_step=config.get_ema_decay_for_step if config.has_ema else None,
        freeze_filter=get_vlm_freeze_filter(config.model) if config.freeze_vlm else None,
    )
    generator = torch.Generator(device=device).manual_seed(config.seed)
    return Trainer(config=config, model=model, steps=steps, state=steps.init_fn(), generator=generator)


def train(config: TrainConfig, *, device=None, num_steps: int | None = None,
          batch_size: int | None = None, param_dtype: str | None = None) -> list[dict]:
    """Build the model and take ``num_steps`` optimizer steps on the synthetic
    batch; returns the per-step records of ``Trainer.run``."""
    trainer = build_trainer(config, device=device, param_dtype=param_dtype)
    device = trainer.model.device
    num_steps = config.num_train_steps if num_steps is None else num_steps
    batch = fake_train_batch(config.model, batch_size or config.batch_size, device=device, seed=config.seed)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info("training %s: %d params (%s), %d trainable tensors, batch %d on %s",
                config.name, n_params, param_dtype or config.param_dtype,
                len(trainer.state.trainable), batch[1].shape[0], device)
    return trainer.run(batch, num_steps)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", help="config name (lap, debug)")
    parser.add_argument("--num_train_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None, help="per-device batch")
    parser.add_argument("--param_dtype", default=None, choices=("float32", "bfloat16"))
    parser.add_argument("--freeze_vlm", action="store_true")
    parser.add_argument("--device", default=None, help="cuda unless given (cpu must be asked for)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    config = get_config(args.config)
    if args.freeze_vlm:
        config = dataclasses.replace(config, freeze_vlm=True)
    train(config, device=args.device, num_steps=args.num_train_steps,
          batch_size=args.batch_size, param_dtype=args.param_dtype)


if __name__ == "__main__":
    main()
