"""The port's Gemma3 checkpoint remapper (``lap_tpu_torch/training/gemma3_weights.py``)
against ``lap_tpu/training/gemma3_weights.py`` on the CPU.

A synthetic raw Gemma3-IT export of the gemma3_dummy LAPGemma3 (``layer_N``
keys, ``_query_norm``/``_key_norm``, the four block norms,
``mm_input_projection``, ``mm_soft_embedding_norm``, SigLIP
``encoderblock_N`` keys and an 8x8 position-embedding grid for the model's
4x4, plus one key the model does not have), seeded with numpy. The JAX
loader reads it through a patched ``restore_params`` (it reads orbax), the
port's loader from the flat ``.npz`` ``scripts/export_jax_params.py``
writes. Tolerances: every remapped and merged leaf equal exactly (both
stack, rename and resize with the same numpy and scipy calls).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.training import gemma3_weights as jax_g3w  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from lap_tpu_torch.training import gemma3_weights as port_g3w  # noqa: E402
from lap_tpu_torch.training import weight_loaders as port_wl  # noqa: E402
from torch_port_helpers import TORCH_THREADS, flatten, randomize_params, unflatten  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
KW = dict(
    dtype="float32", paligemma_variant="gemma3_dummy", action_expert_variant="gemma3_dummy",
    siglip_variant="dummy", action_dim=7, action_horizon=4, max_token_len=80, image_resolution=(56, 56),
    enable_action_training=True, enable_langact_training=True,
)
SIGLIP = "SigLiPFromPatches_0/siglip_encoder/"


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxLAPConfig(**KW).create_module()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=jmodel.init_params_fn))["params"]
    init = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 81)
    return shapes, init


def raw_export(shapes, seed: int) -> dict:
    """The flat raw Gemma3-IT export whose remap gives the VLM and SigLIP
    leaves of ``shapes`` (the position embeddings on an 8x8 grid)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, s in flatten(shapes).items():
        parts = key.split("/")
        if parts[0] not in ("llm", "img") or any(p.endswith("_1") for p in parts) or "Dense_0" in parts:
            continue
        shape = s.shape
        if key == "img/pos_embedding":
            shape = (1, 64, shape[-1])
        value = rng.standard_normal(shape).astype(np.float32)
        if parts[:2] == ["llm", "layers"]:
            rest = "/".join(parts[2:])
            rest = rest.replace("attn/k_rmsnorm", "attn/_key_norm").replace("attn/q_rmsnorm", "attn/_query_norm")
            if parts[2] == "mlp":
                rest += "/w"
            for i in range(shape[0]):
                out[f"transformer/layer_{i}/{rest}"] = value[i]
        elif parts[0] == "llm":
            out["transformer/" + "/".join(parts[1:])] = value
        elif key == "img/head/kernel":
            out["transformer/embedder/mm_input_projection/w"] = value
        elif key == "img/mm_soft_embedding_norm/scale":
            out["transformer/embedder/mm_soft_embedding_norm/scale"] = value
        elif parts[1] == "Transformer_encoderblock":
            for i in range(shape[0]):
                out[f"{SIGLIP}Transformer/encoderblock_{i}/" + "/".join(parts[2:])] = value[i]
        elif parts[1] == "Transformer_encoder_norm":
            out[f"{SIGLIP}Transformer/encoder_norm/{parts[2]}"] = value
        else:
            out[SIGLIP + "/".join(parts[1:])] = value
    out["transformer/unused_in_the_model/scale"] = rng.standard_normal(3).astype(np.float32)
    return out


def test_remap_matches_jax(setup):
    shapes, _ = setup
    raw = raw_export(shapes, 82)
    ref = jax_g3w.remap_gemma3_export(dict(raw))
    got = port_g3w.remap_gemma3_export(dict(raw))
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert got["llm/layers/attn/q_rmsnorm/scale"].shape == (6, 16)
    assert got["llm/layers/mlp/gating_einsum"].shape == (6, 2, 128, 64)
    assert got["img/Transformer_encoderblock/LayerNorm_0/scale"].shape == (2, 64)
    stacked = port_g3w.stack_scan_layers({"a/layer_1/w": np.ones(2), "a/layer_0/w": np.zeros(2), "b": np.ones(1)})
    np.testing.assert_array_equal(stacked["a/layers/w"], [[0, 0], [1, 1]])
    with pytest.raises(ValueError, match="missing layers"):
        port_g3w.stack_scan_layers({"a/layer_0/w": np.zeros(2), "a/layer_2/w": np.zeros(2)})


def test_loader_merges_as_jax_does(setup, tmp_path, monkeypatch):
    shapes, init = setup
    raw = raw_export(shapes, 83)
    monkeypatch.setattr(jax_g3w, "restore_params", lambda path: unflatten(dict(raw)))
    ref = jax_g3w.Gemma3ScanCompatibleWeightLoader("unused").load(shapes)
    np.savez(tmp_path / "params.npz", **{f"params/{k}": v for k, v in raw.items()})

    model = LAPConfig(**KW).create_module(device="cpu", init_seed=None)
    convert.load_jax_params(model, init)
    loader = port_wl.WeightLoaderChoice(kind="gemma3", params_path=str(tmp_path)).build()
    got = loader.load(convert.jax_params_template(model))
    flat_ref, flat_got = flatten(ref), flatten(got)
    assert sorted(flat_got) == sorted(flat_ref)
    for key, want in flat_ref.items():
        if isinstance(want, jax.ShapeDtypeStruct):
            assert flat_got[key] is None, key  # keeps its init
        else:
            np.testing.assert_array_equal(np.asarray(flat_got[key]), np.asarray(want), err_msg=key)
    assert flat_got["img/pos_embedding"].shape == (1, 16, 64)  # 8x8 resized to 4x4
    assert flat_got["llm/layers/attn/q_einsum_1/w"] is None and flat_got["action_in_proj/kernel"] is None

    # Merged into the model: the loaded leaves replace the init, the rest stay.
    port_wl.load_into(model, loader)
    params = dict(model.named_parameters())
    expected = convert.from_jax_params({k: (np.asarray(v) if not isinstance(v, jax.ShapeDtypeStruct) else
                                            flatten(init)[k]) for k, v in flat_ref.items()})
    for name, value in expected.items():
        torch.testing.assert_close(params[name].detach(), value, rtol=0, atol=0, msg=name)


def test_resize_pos_embedding_matches_jax():
    posemb = np.random.default_rng(84).standard_normal((1, 64 * 64, 8)).astype(np.float32)
    got = port_g3w.resize_pos_embedding(posemb, 256)
    ref = jax_g3w.resize_pos_embedding(posemb, 256)
    assert got.shape == (1, 256, 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert port_g3w.resize_pos_embedding(posemb, 64 * 64) is posemb  # same grid: untouched


def test_a_remap_that_gains_parameters_is_refused(setup, tmp_path, monkeypatch):
    """The conservation check: a remap that copies a source array twice
    raises on both sides."""
    shapes, _ = setup
    raw = raw_export(shapes, 85)
    np.savez(tmp_path / "params.npz", **{f"params/{k}": v for k, v in raw.items()})

    def duplicating(module):
        remap = module.remap_gemma3_export

        def remap_twice(flat):
            out = remap(flat)
            out["llm/a_copy"] = out["llm/embedder/input_embedding"]
            return out

        return remap_twice

    monkeypatch.setattr(jax_g3w, "restore_params", lambda path: unflatten(dict(raw)))
    monkeypatch.setattr(jax_g3w, "remap_gemma3_export", duplicating(jax_g3w))
    monkeypatch.setattr(port_g3w, "remap_gemma3_export", duplicating(port_g3w))
    model = LAPConfig(**KW).create_module(device="meta", init_seed=None)
    with pytest.raises(ValueError, match="GAINED parameters"):
        jax_g3w.Gemma3ScanCompatibleWeightLoader("unused").load(shapes)
    with pytest.raises(ValueError, match="GAINED parameters"):
        port_g3w.Gemma3ScanCompatibleWeightLoader(str(tmp_path / "params.npz")).load(
            convert.jax_params_template(model))


def test_bf16_export_is_resized_in_float32(setup, tmp_path):
    """bfloat16 leaves arrive as 2-byte void (as np.save stores them): the
    position embedding is resized from their f32 values."""
    shapes, _ = setup
    raw = raw_export(shapes, 86)
    pos = torch.from_numpy(raw[SIGLIP + "pos_embedding"]).to(torch.bfloat16)
    raw[SIGLIP + "pos_embedding"] = pos.view(torch.int16).numpy().view(np.dtype("V2"))
    np.savez(tmp_path / "params.npz", **{f"params/{k}": v for k, v in raw.items()})
    model = LAPConfig(**KW).create_module(device="meta", init_seed=None)
    got = port_g3w.Gemma3ScanCompatibleWeightLoader(str(tmp_path)).load(convert.jax_params_template(model))
    want = port_g3w.resize_pos_embedding(pos.float().numpy(), 16)
    np.testing.assert_array_equal(flatten(got)["img/pos_embedding"], want)


def test_to_jax_params_round_trip(setup):
    """A LAPGemma3 state dict through the inverse bridge and back is itself,
    laid out on the JAX tree's paths and shapes."""
    shapes, _ = setup
    model = LAPConfig(**KW).create_module(device="cpu", init_seed=3)
    named = {n: p.detach() for n, p in model.named_parameters()}
    tree = convert.to_jax_params(named, siglip_heads=model.img.config.num_heads)
    assert {k: tuple(v.shape) for k, v in tree.items()} == {k: tuple(v.shape) for k, v in flatten(shapes).items()}
    back = convert.from_jax_params({k: v.numpy() for k, v in tree.items()})
    assert set(back) == set(named)
    for name, value in named.items():
        torch.testing.assert_close(back[name], value, rtol=0, atol=0, msg=name)
