"""The weight bridge (lap_tpu_torch.models.convert) consumes every leaf of the
JAX params tree and fills every parameter of the port, each in its layout."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu_torch.models.convert import from_jax_params, load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from torch_port_helpers import TORCH_THREADS, flatten, randomize_params, tiny_lap_config_kwargs, unflatten  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxLAPConfig(**tiny_lap_config_kwargs(enable_langact_training=True))
    model = cfg.create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn)
    )
    return randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 31)


def _port():
    return LAP(LAPConfig(**tiny_lap_config_kwargs()), device="cpu", init_seed=None)


def test_bridge_consumes_every_leaf_and_fills_every_parameter(jax_params):
    state = from_jax_params(jax_params)
    model = _port()
    assert set(state) == set(dict(model.named_parameters()))
    load_jax_params(model, jax_params)
    # Every leaf element lands somewhere: the element counts agree.
    n_jax = sum(np.size(v) for v in flatten(jax_params).values())
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_bridge_layouts(jax_params):
    model = load_jax_params(_port(), jax_params)
    p = dict(model.named_parameters())
    j = jax_params

    def same(name, ref):
        np.testing.assert_array_equal(p[name].detach().numpy(), ref)

    # flax Dense [in, out] -> Linear [out, in].
    same("action_in_proj.weight", j["action_in_proj"]["kernel"].T)
    # Scan-stacked layers; expert 1 carries the _1 suffix.
    same("llm.layers.2.attn.q_einsum.1.w", j["llm"]["layers"]["attn"]["q_einsum_1"]["w"][2])
    same("llm.layers.3.mlp.0.linear", j["llm"]["layers"]["mlp"]["linear"][3])
    # adaRMS modulation under <norm>_1/Dense_0.
    same(
        "llm.layers.1.pre_ffw_norm.1.modulation_weight",
        j["llm"]["layers"]["pre_ffw_norm_1"]["Dense_0"]["kernel"][1].T,
    )
    same("llm.final_norm.1.modulation_bias", j["llm"]["final_norm_1"]["Dense_0"]["bias"])
    # DenseGeneral [D, N, H] and [N, H, D].
    blk = j["img"]["Transformer_encoderblock"]["MultiHeadDotProductAttention_0"]
    same("img.blocks.1.attn.key.weight", blk["key"]["kernel"][1].reshape(64, -1).T)
    same("img.blocks.1.attn.out.weight", blk["out"]["kernel"][1].reshape(-1, 64).T)
    # Conv HWIO -> OIHW.
    same("img.embedding.weight", j["img"]["embedding"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_fails_on_leftover_or_missing_leaves(jax_params):
    flat = flatten(jax_params)
    extra = dict(flat)
    extra["llm/layers/attn/q_einsum_1/lora_a"] = np.zeros((4, 8, 64, 2), np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        from_jax_params(unflatten(extra))
    missing = {k: v for k, v in flat.items() if k != "time_mlp_out/bias"}
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_params(_port(), unflatten(missing))
