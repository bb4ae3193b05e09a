"""Parity of the port's Gemma and SigLIP modules with lap_tpu on the CPU.

Every parameter is randomised with numpy (norm scales and the adaRMS
modulation included) and carried across by the weight bridge. Both sides run
in f32 with the einsum attention; tolerance atol/rtol 2e-5 covers float32
sums taken in another order through the dummy depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import gemma as jax_gemma  # noqa: E402
from lap_tpu.models import siglip as jax_siglip  # noqa: E402
from lap_tpu_torch.models import gemma as port_gemma  # noqa: E402
from lap_tpu_torch.models import siglip as port_siglip  # noqa: E402
from lap_tpu_torch.models.convert import load_jax_params  # noqa: E402
from lap_tpu_torch.models.init import random_init_  # noqa: E402
from torch_port_helpers import TORCH_THREADS, holder, randomize_params  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def gemma_pair():
    cfg = jax_gemma.get_config("dummy")
    jmod = jax_gemma.Module(configs=[cfg, cfg], embed_dtype="float32", adarms=True, attn_impl="xla")
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), [False, True], method=jmod.init_params)
    )
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 11)
    pmod = port_gemma.Module(
        [port_gemma.get_config("dummy")] * 2, use_adarms=[False, True],
        embed_dtype=torch.float32, attn_impl="xla", device="cpu", dtype=torch.float32,
    )
    random_init_(pmod, 0)  # overwritten below; proves nothing is left behind
    load_jax_params(holder(llm=pmod), {"llm": params})
    return jmod, {"params": params}, pmod


def _gemma_inputs(seed, b=2, p=10, s=4, width=64):
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((b, p, width)).astype(np.float32)
    suffix = rng.standard_normal((b, s, width)).astype(np.float32)
    cond = rng.standard_normal((b, width)).astype(np.float32)
    valid = np.array([p, p - 3])[:b]
    prefix_mask = np.arange(p)[None, :] < valid[:, None]
    prefix_attn = prefix_mask[:, None, :] & np.ones((b, p, 1), bool)
    positions = np.cumsum(prefix_mask, axis=1) - 1
    # Suffix rows: prefix keys by validity, then bidirectional suffix.
    suffix_attn = np.concatenate(
        [np.broadcast_to(prefix_mask[:, None, :], (b, s, p)), np.ones((b, s, s), bool)], axis=-1
    )
    suffix_pos = valid[:, None] + np.arange(s)[None, :]
    return prefix, suffix, cond, prefix_attn, positions, suffix_attn, suffix_pos


def test_gemma_prefill_and_cached_suffix_match_jax(gemma_pair):
    jmod, params, pmod = gemma_pair
    prefix, suffix, cond, prefix_attn, positions, suffix_attn, suffix_pos = _gemma_inputs(12)
    j = jnp.asarray

    (jout, _), jcache = jmod.apply(params, [j(prefix), None], j(positions), j(prefix_attn), [None, None])
    (jsuf_out_0, jsuf_out), jcache2 = jmod.apply(
        params, [None, j(suffix)], j(suffix_pos), j(suffix_attn), [None, j(cond)], kv_cache=jcache
    )
    assert jsuf_out_0 is None

    t = torch.from_numpy
    with torch.no_grad():
        (pout, _), pcache = pmod([t(prefix), None], t(positions), t(prefix_attn), [None, None])
        (_, psuf_out), pcache2 = pmod([None, t(suffix)], t(suffix_pos), t(suffix_attn), [None, t(cond)], kv_cache=pcache)

    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    for got, ref in zip(pcache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(psuf_out.numpy(), np.asarray(jsuf_out), **TOL)
    for got, ref in zip(pcache2, jcache2):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gemma_joint_two_expert_call_matches_jax(gemma_pair):
    jmod, params, pmod = gemma_pair
    prefix, suffix, cond, _, _, _, _ = _gemma_inputs(13)
    b, p, s = prefix.shape[0], prefix.shape[1], suffix.shape[1]
    mask = np.tril(np.ones((p + s, p + s), bool))[None].repeat(b, 0)
    pos = np.broadcast_to(np.arange(p + s), (b, p + s)).astype(np.int32)
    j = jnp.asarray
    (j0, j1), _ = jmod.apply(params, [j(prefix), j(suffix)], j(pos), j(mask), [None, j(cond)])
    t = torch.from_numpy
    with torch.no_grad():
        (p0, p1), _ = pmod([t(prefix), t(suffix)], t(pos), t(mask), [None, t(cond)])
    np.testing.assert_allclose(p0.numpy(), np.asarray(j0), **TOL)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), **TOL)


def test_gemma_fused_qkv_branch_matches_jax():
    """num_kv_heads == num_heads takes the fused qkv einsum (no shipped variant
    does; the branch is ported with the module)."""
    fields = dict(width=32, depth=2, mlp_dim=64, num_heads=4, num_kv_heads=4, head_dim=8)
    jmod = jax_gemma.Module(configs=[jax_gemma.Config(**fields)], embed_dtype="float32", attn_impl="xla")
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), [False], method=jmod.init_params))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 18)
    pmod = port_gemma.Module(
        [port_gemma.Config(**fields)], embed_dtype=torch.float32, attn_impl="xla",
        device="cpu", dtype=torch.float32,
    )
    load_jax_params(holder(llm=pmod), {"llm": params})
    assert pmod.layers[0].attn.fused_qkv
    x = np.random.default_rng(19).standard_normal((2, 6, 32)).astype(np.float32)
    mask = np.tril(np.ones((6, 6), bool))[None].repeat(2, 0)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    (ref,), ref_cache = jmod.apply({"params": params}, [jnp.asarray(x)], jnp.asarray(pos), jnp.asarray(mask))
    with torch.no_grad():
        (got,), cache = pmod([torch.from_numpy(x)], torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(ref_cache[1]), **TOL)


def test_gemma_embedder_matches_jax(gemma_pair):
    jmod, params, pmod = gemma_pair
    tokens = np.random.default_rng(14).integers(0, 257_152, (2, 9)).astype(np.int32)
    ref = jmod.apply(params, jnp.asarray(tokens), method=jmod.embed)
    got = pmod.embed(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_siglip_matches_jax():
    cfg = jax_siglip.get_config("dummy", head_dim_out=48)
    jmod = jax_siglip.SigLIP(config=cfg, dtype="float32", attn_impl="xla")
    images = np.random.default_rng(15).uniform(-1, 1, (3, 28, 42, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(images)))
    params = randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 16)
    ref = jmod.apply({"params": params}, jnp.asarray(images))

    pmod = port_siglip.SigLIP(
        port_siglip.get_config("dummy", head_dim_out=48), image_size=(28, 42),
        attn_impl="xla", device="cpu", dtype=torch.float32,
    )
    load_jax_params(holder(img=pmod), {"img": params})
    with torch.no_grad():
        got = pmod(torch.from_numpy(images))
    assert got.shape == (3, 6, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 14, 20, 3), (1, 28, 28, 3)])
def test_resize_with_pad_matches_jax(shape):
    from lap_tpu.models.preprocessing import resize_with_pad as jax_resize
    from lap_tpu_torch.models.preprocessing import resize_with_pad

    images = np.random.default_rng(17).uniform(-1, 1, shape).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(images), 28, 28))
    got = resize_with_pad(torch.from_numpy(images), 28, 28).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
