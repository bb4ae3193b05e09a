"""The port's mesh and parameter placement (``lap_tpu_torch/parallel``,
``training/array_utils.py``, ``device.py``) against lap_tpu's, on the CPU.

Held to what ``tests/test_parallel.py``, ``tests/test_mesh_layout.py`` and
``tests/test_tensor_parallel.py`` assert: the rank layout against JAX's
``_host_aware_layout`` on fake devices (intra-host groups, whole-host
groups, tp innermost, one host and infeasible layouts falling back to the
device order) and against ``make_mesh`` on the 8 virtual CPU devices;
``pick_fsdp_devices``; each parameter's placement against JAX's
``fsdp_sharding`` spec of its leaf (size-thresholded FSDP, tp alone, both,
and Gemma3), with JAX's counts and bytes. Exact, no tolerance. A gloo world
of 4 CPU processes (``run_world``, 180 s join timeout) checks each rank's
coordinates, data placement and rows, and ``gather_host_json`` /
``global_concat`` / ``sync_global_devices`` over the data ranks.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.parallel import mesh as jax_mesh  # noqa: E402
from lap_tpu.parallel import sharding as jax_sharding  # noqa: E402
from lap_tpu_torch import device as port_device  # noqa: E402
from lap_tpu_torch import parallel  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from lap_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from lap_tpu_torch.parallel import sharding as port_sharding  # noqa: E402
from torch_dist_helpers import run_world  # noqa: E402
from torch_port_helpers import tiny_lap_config_kwargs  # noqa: E402


@dataclasses.dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


def _devices(hosts: int, per_host: int):
    return [FakeDev(h * per_host + i, h) for h in range(hosts) for i in range(per_host)]


@pytest.mark.parametrize("hosts,per_host,fsdp,tp", [
    (4, 4, 2, 1),  # intra-host fsdp groups
    (4, 4, 8, 1),  # groups of two whole hosts
    (2, 4, 8, 1),  # pure fsdp over every host
    (2, 8, 2, 2),  # tp innermost within a host
    (4, 2, 2, 2),  # a model group of a whole host
    (1, 8, 2, 1),  # one host: JAX defers to the topology mesh, the port to the rank order
    (2, 6, 4, 1),  # infeasible: 6 ranks a host hold no whole group of 4
])
def test_rank_layout_matches_jax_host_aware_layout(hosts, per_host, fsdp, tp):
    got = port_mesh.rank_layout(hosts * per_host, fsdp, tp, ranks_per_host=per_host)
    ref = jax_mesh._host_aware_layout(_devices(hosts, per_host), fsdp_devices=fsdp, tp_devices=tp)
    if ref is None:
        assert np.array_equal(got, np.arange(hosts * per_host).reshape(-1, fsdp, tp))
    else:
        assert np.array_equal(got, np.vectorize(lambda d: d.id)(ref))
    for group in got.reshape(-1, fsdp * tp):  # a model group never straddles a host when it fits in one
        if fsdp * tp <= per_host and per_host % (fsdp * tp) == 0:
            assert len({r // per_host for r in group}) == 1


@pytest.mark.parametrize("fsdp,tp", [(4, 1), (2, 2), (1, 2), (8, 1), (1, 1)])
def test_rank_layout_matches_jax_make_mesh_on_one_host(fsdp, tp):
    ref = jax_mesh.make_mesh(fsdp_devices=fsdp, tp_devices=tp)
    got = port_mesh.rank_layout(8, fsdp, tp)
    assert dict(zip(port_mesh.MESH_AXES, got.shape, strict=True)) == dict(ref.shape)
    assert np.array_equal(got, np.vectorize(lambda d: d.id)(ref.devices))


def test_infeasible_and_pipeline_meshes_raise():
    with pytest.raises(ValueError, match="not divisible"):
        port_mesh.rank_layout(8, 3, 1)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(fsdp_devices=3)
    with pytest.raises(ValueError, match=">= 1"):
        port_mesh.MeshConfig(fsdp_devices=0)
    with pytest.raises(NotImplementedError, match="13b"):
        port_mesh.make_mesh(1, 1, pp_devices=2)


@pytest.mark.parametrize("requested,n", [(16, 8), (3, 8), (1, 8), (5, 12), (6, 4), (2, 1)])
def test_pick_fsdp_devices_matches_jax(requested, n):
    assert port_mesh.pick_fsdp_devices(requested, n) == jax_mesh.pick_fsdp_devices(requested, n)


def _jax_specs(kw, mesh, min_size_bytes):
    model = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn))["params"]
    tree = jax_sharding.fsdp_sharding(shapes, mesh, min_size_bytes=min_size_bytes)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    specs, sizes = {}, {}
    for path, sharding in flat:
        key = jax.tree_util.keystr(path).replace("'", "").replace("][", "/").strip("[]")
        specs[key] = tuple(sharding.spec)
        leaf = leaves[path]
        sizes[key] = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return specs, sizes


GEMMA3 = dict(tiny_lap_config_kwargs(enable_langact_training=True), paligemma_variant="gemma3_dummy",
              action_expert_variant="gemma3_dummy", max_token_len=48, image_resolution=(56, 56))


@pytest.mark.parametrize("name,kw,fsdp,tp,min_size", [
    ("thresholded", tiny_lap_config_kwargs(enable_langact_training=True), 8, 1, jax_sharding.DEFAULT_MIN_SIZE_BYTES),
    ("tp_isolated", tiny_lap_config_kwargs(enable_langact_training=True), 2, 2, 1 << 62),
    ("fsdp_and_tp", tiny_lap_config_kwargs(enable_langact_training=True), 2, 2, 1024),
    ("gemma3", GEMMA3, 2, 2, 1024),
])
def test_placement_matches_jax_fsdp_sharding(name, kw, fsdp, tp, min_size, caplog):
    specs, sizes = _jax_specs(kw, jax_mesh.make_mesh(fsdp_devices=fsdp, tp_devices=tp), min_size)
    model = LAPConfig(**kw).create_module(device="meta", init_seed=None)
    mesh = {"dp": 8 // (fsdp * tp), "fsdp": fsdp, "tp": tp}
    with caplog.at_level(logging.INFO, logger="lap_tpu_torch.parallel.sharding"):
        plan = port_sharding.fsdp_sharding(model, mesh, min_size_bytes=min_size, log=True)
    for pname, placement in plan.placements.items():
        assert placement.jax_spec == specs[placement.jax_path], (pname, placement)
    sharded = [k for k, s in specs.items() if s != ()]
    assert (plan.num_sharded, plan.num_replicated) == (len(sharded), len(specs) - len(sharded))
    assert plan.sharded_bytes == sum(sizes[k] for k in sharded)
    assert plan.replicated_bytes == sum(sizes.values()) - plan.sharded_bytes
    assert f"{plan.num_sharded} sharded" in caplog.text
    if tp > 1:
        # Heads and MLP hidden dims over tp, in the port's layouts; never the embedding.
        q = plan.placements["llm.layers.0.attn.q_einsum.0.w"]
        assert q.tp_dim == 0 and "tp" in q.jax_spec
        gate = plan.placements["llm.layers.0.mlp.0.gating_einsum"]
        hidden = 1 if name == "gemma3" else 2
        assert gate.tp_dim == hidden
        assert plan.placements["llm.embedder.input_embedding"].tp_dim is None
        kv = plan.placements["llm.layers.0.attn.kv_einsum.0.w"]
        assert kv.tp_dim == (1 if name == "gemma3" else None)  # 2 KV heads split; 1 KV head cannot
    assert port_sharding.describe_sharding(plan).count("\n") == len(plan.placements) - 1


def test_per_rank_bytes_of_a_plan_on_meta():
    model = LAPConfig(**tiny_lap_config_kwargs()).create_module(device="meta", init_seed=None)
    whole = port_sharding.fsdp_sharding(model, {"fsdp": 1, "tp": 1}, min_size_bytes=0)
    split = port_sharding.fsdp_sharding(model, {"fsdp": 4, "tp": 1}, min_size_bytes=0)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    assert whole.per_rank_bytes == total == whole.replicated_bytes + whole.sharded_bytes
    assert split.per_rank_bytes < total / 3


def test_ambient_mesh_state():
    assert port_mesh.get_mesh() is None and not port_mesh.sequence_parallel_enabled()
    tp2 = {"dp": 1, "fsdp": 1, "tp": 2}
    with port_mesh.set_mesh(tp2, sequence_parallel=True):
        assert port_mesh.get_mesh() is tp2 and port_mesh.sequence_parallel_enabled()
        with pytest.raises(ValueError, match="already active"), port_mesh.set_mesh(tp2):
            pass
        with port_mesh.suspend_mesh():
            assert port_mesh.get_mesh() is None
        assert port_mesh.sequence_parallel_enabled()
    with port_mesh.set_mesh({"fsdp": 2}, sequence_parallel=True):
        assert not port_mesh.sequence_parallel_enabled()  # sp is a no-op without tp
    tree = {"a": torch.ones(2)}
    assert parallel.activation_sharding_constraint(tree) is tree


@pytest.mark.parametrize("length,tp", [(16, 2), (10, 4), (1, 2), (4, 4), (692, 2), (10, 2)])
def test_sequence_sharding_rule_is_jaxs(length, tp):
    assert port_mesh.sequence_sharded(length, tp) == (length >= tp and length % tp == 0 and tp > 1)


def test_parallel_exports_jaxs_names_without_the_pipeline():
    import lap_tpu.parallel as jax_parallel

    jax_names = {n for n in jax_parallel.__all__
                 if "pipeline" not in n and not n.startswith(("pp_", "PP_", "make_pp", "check_pp", "stage_"))}
    assert jax_names <= set(parallel.__all__)
    assert PartitionSpec  # the JAX side's placements are PartitionSpecs; the port's are tuples of axis names


def test_resolve_device_rules(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert port_device.resolve_device() == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert port_device.resolve_device() == torch.device("cuda:1")
    assert port_device.resolve_device("cuda:0") == torch.device("cuda:0")  # an explicit device wins
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="local rank 2 has no card"):
        port_device.resolve_device()
    assert port_device.process_placement() == (0, 1)


@pytest.mark.parametrize("cuda,backend,device,expected", [
    (True, None, None, "nccl"),
    (True, None, "cpu", "gloo"),
    (True, None, "cuda:0", "nccl"),
    (False, None, None, "gloo"),
    (True, "gloo", "cuda:0", "gloo"),  # the caller's backend wins
])
def test_init_distributed_backend_follows_the_device(monkeypatch, cuda, backend, device, expected):
    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group", joined.append)
    monkeypatch.setattr(port_mesh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert port_mesh.init_distributed(backend, device=device) == (0, 1)
    assert joined == [expected]
    monkeypatch.delenv("WORLD_SIZE")
    assert port_mesh.init_distributed(backend, device=device) == (0, 1)  # no torchrun environment: joins nothing
    assert joined == [expected]


@pytest.fixture(scope="module")
def world():
    return run_world(4, "torch_dist_workers:placement_cases")


def test_each_rank_sees_its_mesh_coordinates_and_data_rows(world):
    layout = port_mesh.rank_layout(4, 2, 2)
    for rank, out in enumerate(world):
        assert out["device"] == "cpu"
        got = out[(2, 2)]
        coord = {a: int(i) for a, i in zip(port_mesh.MESH_AXES, np.argwhere(layout == rank)[0], strict=True)}
        assert got["coord"] == coord and got["tp_size"] == 2
        # The tp ranks of a group share their data index and rows.
        assert got["placement"] == (coord["fsdp"], 2)
        assert got["rows"] == list(range(8))[coord["fsdp"]::2]
        dp = out[(2, 1)]
        assert dp["placement"] == (rank, 4) and dp["rows"] == [rank, rank + 4] and dp["tp_size"] is None


def test_gather_host_json_and_global_concat_run_over_the_data_ranks(world):
    for rank, out in enumerate(world):
        tp_mesh = out[(2, 2)]
        peers = [r for r in range(4) if r % 2 == rank % 2]  # this rank's data group: same tp coordinate
        assert tp_mesh["json"] == [{"rank": r, "index": i} for i, r in enumerate(peers)]
        assert tp_mesh["concat"] == [float(r) for r in peers for _ in range(2)]
        dp = out[(2, 1)]
        assert dp["json"] == [{"rank": r, "index": r} for r in range(4)]
        assert dp["concat"] == [float(r) for r in range(4) for _ in range(2)]


def test_array_utils_without_a_process_group():
    from lap_tpu_torch.training import array_utils

    assert array_utils.gather_host_json({"a": 1}) == [{"a": 1}]
    assert array_utils.global_concat(torch.arange(3.0)).tolist() == [0.0, 1.0, 2.0]
    array_utils.sync_global_devices("noop")
    assert "(2, 3) torch.float32" in array_utils.tree_info({"x": {"y": torch.zeros(2, 3)}})


def test_lora_under_tp_is_refused():
    """LoRA adapters stay whole under tp in JAX; their row-parallel term
    needs a collective of its own, which is not ported: refused before any
    weight is sliced."""
    model = LAPConfig(**tiny_lap_config_kwargs(paligemma_variant="dummy_lora")).create_module(
        device="meta", init_seed=None)
    tp2 = {"dp": 1, "fsdp": 1, "tp": 2}
    with pytest.raises(NotImplementedError, match="LoRA"):
        port_sharding.parallelize_(model, tp2, port_sharding.fsdp_sharding(model, tp2))
