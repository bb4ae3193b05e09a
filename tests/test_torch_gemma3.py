"""Parity of the port's Gemma3 backbone and SigLIP's Gemma3 extensions with
lap_tpu on the CPU (the counterpart of ``tests/test_gemma3.py``).

Every parameter is randomised with numpy (the QK norms, the post norms and
the adaRMS modulation included) and carried across by the weight bridge.
Both sides run in f32 with the einsum attention; tolerance atol/rtol 2e-5
(float32 sums in another order through 6 layers); RoPE and QKRMSNorm alone
to 1e-6 (f32) and one bf16 ulp (bf16); the parameter counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import gemma3 as jax_gemma3  # noqa: E402
from lap_tpu.models import siglip as jax_siglip  # noqa: E402
from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.ops.masks import make_attn_mask as jax_make_attn_mask  # noqa: E402
from lap_tpu_torch.models import gemma3 as port_gemma3  # noqa: E402
from lap_tpu_torch.models import siglip as port_siglip  # noqa: E402
from lap_tpu_torch.models.convert import load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from torch_port_helpers import TORCH_THREADS, holder, randomize_params  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
TOL = dict(atol=2e-5, rtol=2e-5)
CFG = jax_gemma3.get_config("gemma3_dummy")
PORT_CFG = port_gemma3.get_config("gemma3_dummy")


def _pair(n_experts=2, adarms=True, cfg=CFG, port_cfg=PORT_CFG, seed=21):
    jmod = jax_gemma3.Module(configs=[cfg] * n_experts, embed_dtype="float32", adarms=adarms, attn_impl="xla")
    use = [False, True][:n_experts] if adarms else [False] * n_experts
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), tuple(use), method=jmod.init_params))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), seed)
    pmod = port_gemma3.Module([port_cfg] * n_experts, use_adarms=use, embed_dtype=torch.float32, attn_impl="xla",
                              device="cpu", dtype=torch.float32)
    load_jax_params(holder(llm=pmod), {"llm": params})
    return jmod, {"params": params}, pmod


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(seed, b=2, t0=10, t1=4, width=64):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, t0, width)).astype(np.float32)
    x1 = rng.standard_normal((b, t1, width)).astype(np.float32)
    cond = rng.standard_normal((b, width)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t0 + t1), (b, t0 + t1)).astype(np.int32)
    mask = np.asarray(jax_make_attn_mask(jnp.ones((b, t0 + t1), bool),
                                         jnp.tile(jnp.array([0] * t0 + [1] * t1)[None], (b, 1))))
    return x0, x1, cond, pos, mask


def _port(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def test_attention_pattern():
    cfg = port_gemma3.get_config("gemma3_4b")
    types = [cfg.get_attention_type(i) for i in range(12)]
    assert types[:6] == ["local"] * 5 + ["global"]
    assert types[6:12] == ["local"] * 5 + ["global"]
    ref = jax_gemma3.get_config("gemma3_4b")
    assert [cfg.is_global(i) for i in range(34)] == list(np.asarray(ref.is_global_attn_array()))


def test_variant_sizes():
    cfg = port_gemma3.get_config("gemma3_4b")
    assert (cfg.width, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads) == (2560, 34, 8, 4)
    cfg = port_gemma3.get_config("gemma3_27b")
    assert (cfg.width, cfg.head_dim, cfg.num_layers) == (5376, 128, 62)
    assert port_gemma3._VARIANTS == jax_gemma3._VARIANTS
    for name in jax_gemma3._VARIANTS:
        ref = dataclasses.asdict(jax_gemma3.get_config(name))
        assert dataclasses.asdict(port_gemma3.get_config(name)) == ref, name


def test_forward_and_param_names(pair):
    jmod, params, pmod = pair
    x0, x1, cond, pos, mask = _inputs(22)
    (j0, j1), _ = jmod.apply(params, [jnp.asarray(x0), jnp.asarray(x1)], jnp.asarray(pos), jnp.asarray(mask),
                             [None, jnp.asarray(cond)])
    tx0, tx1, tcond, tpos, tmask = _port(x0, x1, cond, pos, mask)
    with torch.no_grad():
        (p0, p1), _ = pmod([tx0, tx1], tpos, tmask, [None, tcond])
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), **TOL)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), **TOL)
    names = dict(pmod.named_parameters())
    assert "layers.0.attn.q_rmsnorm.scale" in names and "layers.0.attn.k_rmsnorm.scale" in names
    assert "layers.0.post_attention_norm.scale" in names and "layers.0.post_ffw_norm.scale" in names
    assert not any("post_attention_norm.1" in n or "post_ffw_norm.1" in n for n in names)  # expert 0 only
    assert names["layers.0.mlp.0.gating_einsum"].shape == (2, CFG.hidden_dim, CFG.width)  # [2, H, F]


def test_sliding_window_restricts_attention():
    """A single local layer: outputs beyond the window do not see token 0;
    and the port agrees with JAX on it."""
    cfg_local = dataclasses.replace(CFG, num_layers=1, sliding_window_pattern=99)
    port_local = dataclasses.replace(PORT_CFG, num_layers=1, sliding_window_pattern=99)
    jmod, params, pmod = _pair(1, adarms=False, cfg=cfg_local, port_cfg=port_local, seed=23)
    b, t = 1, 12
    x = np.random.default_rng(24).standard_normal((b, t, CFG.width)).astype(np.float32)
    pos = np.arange(t)[None].astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None]
    x2 = x.copy()
    x2[:, 0] += 10.0
    outs = []
    for inp in (x, x2):
        (ref,), _ = jmod.apply(params, [jnp.asarray(inp)], jnp.asarray(pos), jnp.asarray(mask))
        with torch.no_grad():
            (got,), _ = pmod(_port(inp), *_port(pos, mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        outs.append(got.numpy())
    diff = np.abs(outs[1] - outs[0]).max(axis=-1)[0]
    assert diff[0] > 0
    assert diff[5:].max() < 1e-5  # beyond the window (4): unchanged


def test_image_bidir_attention(pair):
    jmod, params, pmod = _pair(1, adarms=False, seed=25)
    b, t = 1, 8
    x = np.random.default_rng(26).standard_normal((b, t, CFG.width)).astype(np.float32)
    pos = np.arange(t)[None].astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None]
    img = np.zeros((b, t), bool)
    img[:, 2:6] = True
    (ref,), _ = jmod.apply(params, [jnp.asarray(x)], jnp.asarray(pos), jnp.asarray(mask), [None],
                           image_mask=jnp.asarray(img))
    with torch.no_grad():
        (causal,), _ = pmod(_port(x), *_port(pos, mask), [None])
        (got,), _ = pmod(_port(x), *_port(pos, mask), [None], image_mask=torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.abs(got[0, 2].numpy() - causal[0, 2].numpy()).max() > 1e-6  # image token 2 sees 3..5
    np.testing.assert_allclose(got[0, 0].numpy(), causal[0, 0].numpy(), atol=1e-6)


def test_prefill_then_ar_decode_matches_full_forward_and_jax():
    """Cached single-token decode (the cache written in place) reproduces the
    full forward, with the sliding window crossed (window 4, 9 tokens), and
    every step matches JAX's."""
    jmod, params, pmod = _pair(1, adarms=False, seed=27)
    b, t0, steps = 1, 7, 2
    t = t0 + steps
    x = np.random.default_rng(28).standard_normal((b, t, CFG.width)).astype(np.float32)
    pos = np.arange(t)[None].astype(np.int32)
    full_mask = np.tril(np.ones((t, t), bool))[None]
    with torch.no_grad():
        (full,), _ = pmod(_port(x), *_port(pos, full_mask))
        pre_mask = np.pad(full_mask[:, :t0, :t0], ((0, 0), (0, 0), (0, steps)))
        (pre,), cache = pmod(_port(x[:, :t0]), *_port(pos[:, :t0], pre_mask))
        np.testing.assert_allclose(pre.numpy(), full[:, :t0].numpy(), atol=1e-5, rtol=1e-5)
        (_,), jcache = jmod.apply(params, [jnp.asarray(x[:, :t0])], jnp.asarray(pos[:, :t0]), jnp.asarray(pre_mask))
        for i in range(t0, t):
            (step,), cache = pmod(_port(x[:, i : i + 1]), *_port(pos[:, i : i + 1], full_mask[:, i : i + 1]),
                                  kv_cache=cache)
            (jstep,), jcache = jmod.apply(params, [jnp.asarray(x[:, i : i + 1])], jnp.asarray(pos[:, i : i + 1]),
                                          jnp.asarray(full_mask[:, i : i + 1]), kv_cache=jcache)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)
        for got, ref in zip(cache, jcache, strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_suffix_decode_matches_full_forward_and_jax(pair):
    """The flow pattern: prefill expert 0, then expert 1's suffix against the
    cache, equal to the joint forward (windows across the boundary)."""
    jmod, params, pmod = _pair(2, adarms=False, seed=29)
    x0, x1, _, pos, mask = _inputs(30, b=1, t0=7, t1=3)
    t0 = x0.shape[1]
    with torch.no_grad():
        (_, full1), _ = pmod(_port(x0, x1), *_port(pos, mask))
        _, cache = pmod([torch.from_numpy(x0), None], *_port(pos[:, :t0], mask[:, :t0, :t0]))
        (_, suffix), _ = pmod([None, torch.from_numpy(x1)], *_port(pos[:, t0:], mask[:, t0:]), kv_cache=cache)
    np.testing.assert_allclose(suffix.numpy(), full1.numpy(), atol=1e-5, rtol=1e-5)
    _, jcache = jmod.apply(params, [jnp.asarray(x0), None], jnp.asarray(pos[:, :t0]), jnp.asarray(mask[:, :t0, :t0]))
    (_, jsuffix), _ = jmod.apply(params, [None, jnp.asarray(x1)], jnp.asarray(pos[:, t0:]), jnp.asarray(mask[:, t0:]),
                                 kv_cache=jcache)
    np.testing.assert_allclose(suffix.numpy(), np.asarray(jsuffix), **TOL)


def test_the_vlm_config_decides_the_window_and_the_rope_bases():
    """An expert whose own window and RoPE bases differ from the VLM's: both
    sides take the VLM's (``configs[0]``) for every row, so the outputs
    agree; the port's would not if it read the expert's."""
    expert = dataclasses.replace(CFG, sliding_window_size=2, rope_local_base_freq=77.0,
                                 rope_global_base_freq=5_000.0)
    port_expert = dataclasses.replace(PORT_CFG, sliding_window_size=2, rope_local_base_freq=77.0,
                                      rope_global_base_freq=5_000.0)
    jmod = jax_gemma3.Module(configs=[CFG, expert], embed_dtype="float32", attn_impl="xla")
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), (False, False), method=jmod.init_params))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 38)
    pmod = port_gemma3.Module([PORT_CFG, port_expert], embed_dtype=torch.float32, attn_impl="xla", device="cpu",
                              dtype=torch.float32)
    load_jax_params(holder(llm=pmod), {"llm": params})
    x0, x1, _, pos, mask = _inputs(39, t0=10, t1=6)
    (_, ref), _ = jmod.apply({"params": params}, [jnp.asarray(x0), jnp.asarray(x1)], jnp.asarray(pos),
                             jnp.asarray(mask))
    with torch.no_grad():
        (_, got), _ = pmod(_port(x0, x1), *_port(pos, mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        own = port_gemma3.Module([port_expert, port_expert], embed_dtype=torch.float32, attn_impl="xla",
                                 device="cpu", dtype=torch.float32)
        own.load_state_dict(pmod.state_dict())
        (_, other), _ = own(_port(x0, x1), *_port(pos, mask))
    assert np.abs(other.numpy() - got.numpy()).max() > 1e-3  # the expert's own window and bases differ


def test_joint_stop_gradient_pass_and_every_gradient_match_jax():
    """Both experts with adaRMS and ``stop_action_to_vlm_grad``: outputs and
    the gradient of every leaf of a loss over both outputs."""
    jmod = jax_gemma3.Module(configs=[CFG, CFG], embed_dtype="float32", adarms=True, attn_impl="xla",
                             stop_action_to_vlm_grad=True)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), (False, True), method=jmod.init_params))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 31)
    pmod = port_gemma3.Module([PORT_CFG] * 2, use_adarms=[False, True], embed_dtype=torch.float32, attn_impl="xla",
                              stop_action_to_vlm_grad=True, device="cpu", dtype=torch.float32)
    load_jax_params(holder(llm=pmod), {"llm": params})
    x0, x1, cond, pos, mask = _inputs(32)
    rng = np.random.default_rng(33)
    w0, w1 = rng.standard_normal(x0.shape).astype(np.float32), rng.standard_normal(x1.shape).astype(np.float32)
    img = np.zeros(pos.shape, bool)
    img[:, 2:6] = True

    def jax_loss(p):
        (o0, o1), _ = jmod.apply({"params": p}, [jnp.asarray(x0), jnp.asarray(x1)], jnp.asarray(pos),
                                 jnp.asarray(mask), [None, jnp.asarray(cond)], image_mask=jnp.asarray(img))
        return jnp.sum(o0 * w0) + jnp.sum(o1 * w1)

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    (o0, o1), _ = pmod(_port(x0, x1), *_port(pos, mask), [None, torch.from_numpy(cond)],
                       image_mask=torch.from_numpy(img), want_cache=False)
    loss = (o0 * torch.from_numpy(w0)).sum() + (o1 * torch.from_numpy(w1)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    from lap_tpu_torch.models.convert import from_jax_params

    ref = from_jax_params({"llm": jax.tree.map(np.asarray, ref_grads)})
    for name, p in pmod.named_parameters():
        want = ref[f"llm.{name}"].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 2e-6, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", [10_000.0, 1_000_000.0])
def test_apply_rope_interleaved_matches_jax(dtype, base):
    rng = np.random.default_rng(34)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    ref = jax_gemma3.apply_rope_interleaved(jnp.asarray(x, dtype), jnp.asarray(pos), base)
    got = port_gemma3.apply_rope_interleaved(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), base)
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    # Interleaved pairs: channels (0, 1) rotate together, not (0, H/2).
    rotated = port_gemma3.apply_rope_interleaved(torch.from_numpy(x), torch.ones((2, 5), dtype=torch.int32), base)
    np.testing.assert_allclose(np.linalg.norm(rotated.numpy()[..., :2], axis=-1),
                               np.linalg.norm(x[..., :2], axis=-1), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    jmod = jax_gemma3.QKRMSNorm()
    ref = jmod.apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, dtype))
    norm = port_gemma3.QKRMSNorm(16, dtype=torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=0, rtol=8e-3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)
    # A direct scale: an all-ones scale leaves the RMS-normalised input.
    with torch.no_grad():
        norm.scale.fill_(1.0)
        unit = norm(torch.from_numpy(x))
    np.testing.assert_allclose(np.sqrt((unit.numpy() ** 2).mean(-1)), 1.0, rtol=1e-5)


def test_siglip_gemma3_extensions_match_jax():
    """The soft-embedding norm, pooling (16 tokens to 4) and a bias-free head."""
    kw = dict(pool_to_tokens=4, head_dim_out=48, head_bias=False, soft_embedding_norm=True)
    jmod = jax_siglip.SigLIP(config=jax_siglip.get_config("dummy", **kw), dtype="float32", attn_impl="xla")
    images = np.random.default_rng(36).uniform(-1, 1, (3, 56, 56, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(images)))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 37)
    assert "bias" not in params["head"] and "mm_soft_embedding_norm" in params
    ref = jmod.apply({"params": params}, jnp.asarray(images))
    pmod = port_siglip.SigLIP(port_siglip.get_config("dummy", **kw), image_size=(56, 56), attn_impl="xla",
                              device="cpu", dtype=torch.float32)
    load_jax_params(holder(img=pmod), {"img": params})
    with torch.no_grad():
        got = pmod(torch.from_numpy(images))
    assert got.shape == (3, 4, 48) and pmod.head.bias is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant,expert", [("gemma3_4b", "gemma3_300m"), ("gemma3_12b", "gemma3_300m_48"),
                                            ("gemma3_27b", "gemma3_300m_62")])
def test_parameter_counts_match_jax(variant, expert):
    """LAPGemma3 at the named configs' widths and depths, built on the meta
    device, has as many parameters, leaf by leaf, as JAX's ``eval_shape``."""
    kw = dict(paligemma_variant=variant, action_expert_variant=expert, action_dim=7, action_horizon=16,
              max_token_len=16, enable_action_training=True, enable_langact_training=True)
    jmodel = JaxLAPConfig(**kw).create_module()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=jmodel.init_params_fn))
    ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    model = LAPConfig(**kw).create_module(device="meta", init_seed=None)
    from lap_tpu_torch.models.convert import jax_params_template
    from torch_port_helpers import flatten

    template = jax_params_template(model)
    want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    assert {k: tuple(v.shape) for k, v in template.items()} == want
    assert sum(p.numel() for p in model.parameters()) == ref
