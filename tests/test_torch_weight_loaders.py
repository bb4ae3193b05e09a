"""The port's weight loaders (``lap_tpu_torch/training/weight_loaders.py``)
against ``lap_tpu/training/weight_loaders.py`` on the CPU.

A seeded dummy PaliGemma ``.npz`` (expert 0 and SigLIP in big_vision's
layout; f32, and bf16 stored as 2-byte void) goes through JAX's
``PaliGemmaWeightLoader`` + ``merge_params`` + placement over a seeded init,
and through the port's loader over the same init. Tolerances: the merged
parameters are equal exactly (both copy the loaded leaves and cast bf16 to
f32, which is exact); ``sample_actions`` of the two models at the same noise
agree to 2e-5 (f32). ``missing_regex`` is matched against JAX paths on both
sides, with the same outcome.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.training import weight_loaders as jax_wl  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from lap_tpu_torch.training import checkpoints  # noqa: E402
from lap_tpu_torch.training import weight_loaders as port_wl  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    flatten,
    jax_observation,
    port_observation,
    random_obs_arrays,
    randomize_params,
    tiny_lap_config_kwargs,
)

torch.set_num_threads(TORCH_THREADS)

KW = tiny_lap_config_kwargs()


@pytest.fixture(scope="module")
def jax_setup():
    cfg = JaxLAPConfig(**KW)
    model = cfg.create_module()
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn)
    )["params"]
    init = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 90)
    pretrained = flatten(randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 91))
    return model, shapes, init, pretrained


def _paligemma_npz(path, pretrained: dict, *, bf16: bool):
    """Expert 0 and SigLIP under big_vision's names (``params/`` prefix,
    ``img/Transformer/encoderblock``); bf16 as np.save stores it."""
    out = {}
    for key, value in pretrained.items():
        top = key.split("/")
        if top[0] not in ("llm", "img") or any(p.endswith("_1") for p in top):
            continue
        key = key.replace("img/Transformer_encoderblock/", "img/Transformer/encoderblock/")
        key = key.replace("img/Transformer_encoder_norm/", "img/Transformer/encoder_norm/")
        arr = np.asarray(value, np.float32)
        if bf16:
            arr = np.asarray(jnp.asarray(arr, jnp.bfloat16)).view(np.dtype("V2"))
        out[f"params/{key}"] = arr
    np.savez(path, **out)
    return path


def _jax_merged(loader, shapes, init):
    loaded = loader.load(shapes)
    return jax.tree.map(lambda new, cur: cur if isinstance(new, jax.ShapeDtypeStruct) else
                        np.asarray(jnp.asarray(new, jnp.float32)), loaded, init)


@pytest.fixture(scope="module")
def jax_sample(jax_setup):
    """``sample_actions`` jitted once (both cases share the compile)."""
    jmodel = jax_setup[0]
    return jax.jit(lambda p, o, n: jmodel.apply(
        {"params": p}, jax.random.PRNGKey(0), o, noise=n, method=jmodel.sample_actions))


def _port_model(init) -> LAP:
    return convert.load_jax_params(LAP(LAPConfig(**KW), device="cpu", init_seed=None), init)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_void"])
def test_paligemma_npz_merges_as_jax_does(tmp_path, jax_setup, jax_sample, bf16):
    _, shapes, init, pretrained = jax_setup
    npz = _paligemma_npz(tmp_path / "pg.npz", pretrained, bf16=bf16)
    merged = _jax_merged(jax_wl.PaliGemmaWeightLoader(str(npz)), shapes, init)

    port = _port_model(init)
    port_wl.load_into(port, port_wl.WeightLoaderChoice(kind="paligemma2" if bf16 else "paligemma",
                                                        params_path=str(npz)).build())
    ref = convert.from_jax_params(merged)
    got = dict(port.named_parameters())
    assert set(ref) == set(got)
    for name, value in ref.items():
        assert torch.equal(got[name].detach(), value), name
    # Expert 1 and the projections kept the init; expert 0 took the file.
    init_sd = convert.from_jax_params(init)
    assert torch.equal(got["llm.layers.0.mlp.1.linear"].detach(), init_sd["llm.layers.0.mlp.1.linear"])
    assert not torch.equal(got["llm.layers.0.mlp.0.linear"].detach(), init_sd["llm.layers.0.mlp.0.linear"])

    arrays = random_obs_arrays(92, batch=2, valid=[12, 7], cfg_kw=KW)
    noise = np.random.default_rng(93).standard_normal((2, 4, 7)).astype(np.float32)
    jactions = np.asarray(jax_sample(merged, jax_observation(arrays), jnp.asarray(noise)))
    pactions = port.sample_actions(port_observation(arrays), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(pactions, jactions, rtol=2e-5, atol=2e-5)


def test_checkpoint_loader_reads_the_ports_params_and_an_export(tmp_path, jax_setup):
    _, shapes, init, pretrained = jax_setup
    source = _port_model(pretrained)  # a "trained" model
    checkpoints.save_params(source, tmp_path / "port" / "params")
    npz_dir = tmp_path / "jax" / "params"
    npz_dir.mkdir(parents=True)
    np.savez(npz_dir / port_wl.NPZ_FILE, **{f"params/{k}": np.asarray(v) for k, v in pretrained.items()})
    for params_dir in (tmp_path / "port" / "params", npz_dir):
        port = _port_model(init)
        port_wl.load_into(port, port_wl.CheckpointWeightLoader(str(params_dir)))
        ref = dict(source.named_parameters())
        assert all(torch.equal(p, ref[n]) for n, p in port.named_parameters()), params_dir


def test_merge_params_honours_missing_regex_in_jax_paths(jax_setup):
    _, shapes, _, pretrained = jax_setup
    template = convert.jax_params_template(LAP(LAPConfig(**KW), device="cpu", init_seed=None))
    partial = {k: v for k, v in pretrained.items() if "final_norm" not in k}
    for regex in (".*final_norm.*", "llm/final_norm.*"):
        jax_out = flatten(jax_wl.merge_params(partial, shapes, missing_regex=regex))
        port_out = port_wl.flatten(port_wl.merge_params(partial, template, missing_regex=regex))
        assert set(jax_out) == set(port_out)
        kept = {k for k, v in jax_out.items() if isinstance(v, jax.ShapeDtypeStruct)}
        assert kept == {k for k, v in port_out.items() if v is None} and kept
        assert all("final_norm" in k for k in kept)
    for regex in (".*lora.*", "final_norm"):  # fullmatch: a bare substring does not match a path
        with pytest.raises(ValueError, match="missing from checkpoint"):
            jax_wl.merge_params(partial, shapes, missing_regex=regex)
        with pytest.raises(ValueError, match="missing from checkpoint"):
            port_wl.merge_params(partial, template, missing_regex=regex)
    bad = dict(pretrained)
    bad["llm/embedder/input_embedding"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch for llm/embedder/input_embedding"):
        jax_wl.merge_params(bad, shapes)
    with pytest.raises(ValueError, match="shape mismatch for llm/embedder/input_embedding"):
        port_wl.merge_params(bad, template)


def test_checkpoint_loader_requires_every_non_lora_leaf(tmp_path, jax_setup):
    _, _, init, pretrained = jax_setup
    params_dir = tmp_path / "params"
    params_dir.mkdir()
    np.savez(params_dir / port_wl.NPZ_FILE,
             **{f"params/{k}": np.asarray(v) for k, v in pretrained.items() if not k.startswith("time_mlp_in")})
    with pytest.raises(ValueError, match="time_mlp_in/.* missing from checkpoint"):
        port_wl.load_into(_port_model(init), port_wl.CheckpointWeightLoader(str(params_dir)))
    with pytest.raises(FileNotFoundError, match="export_jax_params"):
        port_wl.load_into(_port_model(init), port_wl.CheckpointWeightLoader(str(tmp_path / "empty")))


def test_inverse_bridge_lays_out_the_jax_tree(jax_setup):
    _, shapes, _, pretrained = jax_setup
    model = _port_model(pretrained)
    template = convert.jax_params_template(model)
    flat_shapes = flatten(shapes)
    assert {k: tuple(v.shape) for k, v in template.items()} == {k: tuple(v.shape) for k, v in flat_shapes.items()}
    back = convert.to_jax_params({n: p.detach() for n, p in model.named_parameters()},
                                 siglip_heads=model.img.config.num_heads)
    for key, value in pretrained.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_recover_dtype_and_void_leaves():
    bf16 = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    void = bf16.view(np.dtype("V2"))
    assert port_wl.recover_dtype(void) is void
    np.testing.assert_array_equal(np.asarray(jax_wl.recover_dtype(void), np.float32), [1.5, -2.25, 3.0])
    t = convert._to_tensor(void)
    assert t.dtype == torch.bfloat16 and t.float().tolist() == [1.5, -2.25, 3.0]
    with pytest.raises(ValueError, match="itemsize 4"):
        port_wl.recover_dtype(np.zeros(2, np.float32).view(np.dtype("V4")))


def test_weight_loader_choice_kinds():
    assert port_wl.WeightLoaderChoice().build() is None
    assert isinstance(port_wl.WeightLoaderChoice(kind="checkpoint", params_path="x").build(),
                      port_wl.CheckpointWeightLoader)
    for kind in ("paligemma", "paligemma2"):
        assert isinstance(port_wl.WeightLoaderChoice(kind=kind, params_path="x.npz").build(),
                          port_wl.PaliGemmaWeightLoader)
    from lap_tpu_torch.training.gemma3_weights import Gemma3ScanCompatibleWeightLoader

    assert isinstance(port_wl.WeightLoaderChoice(kind="gemma3", params_path="x").build(),
                      Gemma3ScanCompatibleWeightLoader)
    for kind in ("checkpoint", "paligemma", "gemma3"):
        with pytest.raises(ValueError, match="requires params_path"):
            port_wl.WeightLoaderChoice(kind=kind).build()
    with pytest.raises(ValueError, match="unknown weight loader kind"):
        port_wl.WeightLoaderChoice(kind="nope").build()
