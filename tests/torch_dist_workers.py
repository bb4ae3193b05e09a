"""Rank bodies of the port's parallelism tests (``torch_dist_helpers.run_world``).

No JAX here: each rank imports the port alone. Inputs arrive as numpy
arrays; a rank takes its rows of a global batch (``mesh.data_sharding``)
and returns numpy arrays (whole tensors gathered with
``sharding.full_tensor``) from rank 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch_port_helpers import port_aug_params, port_observation


def take_rows(tree, rows):
    if isinstance(tree, dict):
        return {k: take_rows(v, rows) for k, v in tree.items()}
    return tree[rows]


def step_randomness(draws: dict, rows) -> dict:
    """A step's explicit randomness (``jax_loss_randomness`` arrays), this rank's rows."""
    return dict(noise=torch.from_numpy(np.array(draws["noise"][rows])),
                time=torch.from_numpy(np.array(draws["time"][rows])),
                aug_params=port_aug_params(take_rows(draws["aug"], rows)))


def _whole(model, tensors: dict) -> dict:
    from lap_tpu_torch.parallel.sharding import full_tensor

    return {n: full_tensor(model, n, t).numpy().copy() for n, t in tensors.items()}


def _loss_and_grads(model, arrays, actions, draws, rows):
    from lap_tpu_torch.parallel import mesh as mesh_lib

    with model.parallel.scope():
        loss, _ = model.compute_loss(port_observation(take_rows(arrays, rows)),
                                     torch.from_numpy(actions[rows]), train=True, **step_randomness(draws, rows))
        loss.backward()
    total = loss.detach().to(torch.float64)
    dist.all_reduce(total, group=mesh_lib.data_group(model.parallel.mesh))
    grads = _whole(model, {n: p.grad for n, p in model.named_parameters()})
    for p in model.parameters():
        p.grad = None
    return float(total), grads


def train_layouts(rank, world, cfg_kw, params, arrays, actions, draws, opt, layouts, ckpt_dir):
    """For each layout (name, fsdp, tp, sp, steps): one loss's gradients,
    then ``steps`` training steps (explicit randomness ``draws[step]``),
    from the JAX params tree ``params``; the (dp 2, fsdp 2) state is saved
    at its last step and a further step taken."""
    from lap_tpu_torch.models.convert import load_jax_params
    from lap_tpu_torch.models.lap_model import LAPConfig
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import parallelize_
    from lap_tpu_torch.training import optimizer as port_opt
    from lap_tpu_torch.training.checkpoints import CheckpointManager
    from lap_tpu_torch.training.train_step import make_step_functions

    out = {}
    for name, fsdp, tp, sp, steps in layouts:
        model = load_jax_params(LAPConfig(**cfg_kw).create_module(device="cpu", init_seed=None), params)
        mesh = mesh_lib.make_mesh(fsdp, tp, device_type="cpu")
        parallelize_(model, mesh, sequence_parallel=sp)
        rows = mesh_lib.data_sharding(mesh, actions.shape[0])
        loss, grads = _loss_and_grads(model, arrays, actions, draws[0], rows)
        fns = make_step_functions(model, port_opt.AdamW(**opt["adam"]), port_opt.CosineDecaySchedule(**opt["sched"]),
                                  ema_decay_for_step=lambda step: (0.9, step >= 1))
        state = fns.init_fn()
        batch = (port_observation(take_rows(arrays, rows)), torch.from_numpy(actions[rows]))
        metrics = []
        for step in range(steps):
            state, m = fns.train_step(state, batch, **step_randomness(draws[step], rows))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "param_norm", "action_loss", "lang_loss")})
        # Validation on the EMA view (swapped into FSDP's shards by copy).
        val = fns.val_step(state, batch, **step_randomness(draws[steps], rows))
        record = dict(loss=loss, grads=grads, metrics=metrics, shape=mesh_lib.mesh_shape(mesh),
                      val_loss=float(val["loss"]), params=_whole(model, dict(model.named_parameters())))
        if ckpt_dir is not None and name == "dp2_fsdp2":
            mgr = CheckpointManager(ckpt_dir)
            mgr.save(steps, state)
            mgr.wait_until_finished()
            record["ema"] = _whole(model, state.ema_params)
            record["mu"] = _whole(model, dict(zip(state.trainable, state.opt_state.mu, strict=True)))
            state, m = fns.train_step(state, batch, **step_randomness(draws[steps], rows))
            record["next_loss"] = float(m["loss"])
        out[name] = record
        dist.barrier()
    return out if rank == 0 else None


def gemma3_grads(rank, world, cfg_kw, params, arrays, actions, draws, fsdp, tp, sp):
    """One LAPGemma3 loss's gradients under (fsdp, tp, sp)."""
    from lap_tpu_torch.models.convert import load_jax_params
    from lap_tpu_torch.models.lap_model import LAPConfig
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import parallelize_

    model = load_jax_params(LAPConfig(**cfg_kw).create_module(device="cpu", init_seed=None), params)
    mesh = mesh_lib.make_mesh(fsdp, tp, device_type="cpu")
    parallelize_(model, mesh, sequence_parallel=sp)
    loss, grads = _loss_and_grads(model, arrays, actions, draws, mesh_lib.data_sharding(mesh, actions.shape[0]))
    return dict(loss=loss, grads=grads) if rank == 0 else None


def run_jobs(rank, world, jobs):
    """Several rank bodies in one world, in order: ``jobs`` is a list of
    (function name in this module, arguments)."""
    return [globals()[name](rank, world, *args) for name, args in jobs]


def _seeded(fn, i):
    import random

    np.random.seed(1000 + i)
    random.seed(1000 + i)
    return fn()


def serving_cases(rank, world, ckpt, requests, bucket, ar_steps):
    """Tensor-parallel serving of the ``debug`` checkpoint at ``ckpt``: flow
    requests, the token bucket, greedy AR, a batched call of two prepared
    requests and two concurrent requests behind ``BatchingPolicy``. Rank 0
    serves; the other ranks follow each policy in turn."""
    import threading

    from lap_tpu_torch.policies import policy as port_policy
    from lap_tpu_torch.policies import policy_config
    from lap_tpu_torch.policies.batching import BatchingPolicy
    from lap_tpu_torch.training import config

    cfg = config.get_config("debug")
    common = dict(default_prompt="do something", device="cpu", allow_test_vocab=True, tp=world)
    flow = policy_config.create_trained_policy(cfg, ckpt, **common)
    bucketed = policy_config.create_trained_policy(cfg, ckpt, token_bucket=bucket, **common)
    ar = policy_config.create_trained_policy_ar(cfg, ckpt, max_decoding_steps=ar_steps, **common)
    policies = (flow, bucketed, ar)
    if rank != 0:
        # One tp group serves the three in turn: each is stopped before the next.
        return [port_policy.serve_followers(p) for p in policies]
    out = {"flow": [_seeded(lambda r=r: flow.infer(r)["actions"], i) for i, r in enumerate(requests)]}
    prepared = [_seeded(lambda r=r: flow._prepare(r), i) for i, r in enumerate(requests[:2])]
    out["batched"] = [r["actions"] for r in flow._infer_prepared(prepared)]
    batcher = BatchingPolicy(flow, max_batch=2, window_ms=200)
    results = [None, None]

    def infer(k):
        results[k] = batcher.infer(requests[k])["actions"]

    threads = [threading.Thread(target=infer, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    port_policy.stop_followers(flow)
    out["batcher"] = dict(results=results, stats=dict(batcher.stats))
    out["bucket"] = [_seeded(lambda r=r: bucketed.infer(r)["actions"], i) for i, r in enumerate(requests)]
    port_policy.stop_followers(bucketed)
    out["ar"], out["ar_tokens"] = _ar_outputs(ar, requests)
    port_policy.stop_followers(ar)
    return out


def _ar_outputs(ar, requests):
    """Each request's AR output (timing dropped) and greedy tokens."""
    tokens = []
    sample = ar._sample

    def recorded(observation, generator):
        tokens.append(sample(observation, generator).numpy().copy())
        return torch.from_numpy(tokens[-1])

    ar._sample = recorded
    outs = []
    for i, r in enumerate(requests):
        result = _seeded(lambda r=r: ar.infer(r), i)
        del result["policy_timing"]
        outs.append(result)
    del ar._sample
    return outs, tokens


def gemma3_flow(rank, world, cfg_kw, weights, arrays, noise, num_steps):
    """LAPGemma3's flow sampling sharded over tp = world, each rank's slices
    copied from the whole weights as ``restore_params_sharded`` copies them."""
    from lap_tpu_torch.models.lap_model import LAPConfig
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.parallel.sharding import parallelize_
    from lap_tpu_torch.training.checkpoints import copy_shards

    model = LAPConfig(**cfg_kw).create_module(device="meta", init_seed=None)
    parallelize_(model, mesh_lib.make_mesh(1, world, device_type="cpu"))
    model.to_empty(device="cpu")
    copy_shards(model, dict(model.named_parameters()), {n: torch.from_numpy(w) for n, w in weights.items()}, "g3")
    actions = model.sample_actions(port_observation(arrays), num_steps=num_steps, noise=torch.from_numpy(noise))
    return actions.numpy() if rank == 0 else None


def placement_cases(rank, world):
    """What a rank of a world of 4 sees of the mesh, the data placement and
    ``array_utils`` under (fsdp 2, tp 2) and then (dp 2, fsdp 2)."""
    from lap_tpu_torch.device import process_placement, resolve_device
    from lap_tpu_torch.parallel import mesh as mesh_lib
    from lap_tpu_torch.training import array_utils

    out = {"device": str(resolve_device("cpu"))}
    for fsdp, tp in ((2, 2), (2, 1)):
        mesh = mesh_lib.make_mesh(fsdp, tp, device_type="cpu")
        index, count = process_placement()
        rows = mesh_lib.data_sharding(mesh, 8)
        out[(fsdp, tp)] = dict(
            coord=mesh_lib.coordinate(mesh), placement=(index, count), rows=list(range(8))[rows],
            json=array_utils.gather_host_json({"rank": rank, "index": index}),
            concat=array_utils.global_concat(torch.full((2,), float(rank))).tolist(),
            tp_size=None if mesh_lib.tp_group(mesh) is None else dist.get_world_size(mesh_lib.tp_group(mesh)))
        array_utils.sync_global_devices("placement")
    return out


def mixture_stats(rank, world, train_config, members):
    """The stats pass of an RLDS mixture with each data rank reading its
    episode shard, merged over the ranks."""
    from lap_tpu_torch.data.mixer import compute_mixture_norm_stats
    from lap_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.make_mesh(world, 1, device_type="cpu")
    stats, transitions = compute_mixture_norm_stats(train_config, members)
    return {k: v.to_dict() for k, v in stats.items()}, transitions
