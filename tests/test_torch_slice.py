"""The ported flow-matching slice against lap_tpu on the CPU.

``sample_actions`` of the dummy flagship-architecture LAP (the config of
tests/test_golden_parity.py) at batch 2 with unequal prompt padding, explicit
numpy noise and randomised parameters, carried across by the weight bridge.
Both sides run in f32. Tolerance: atol/rtol 2e-5 on actions of magnitude ~4
(measured 1.3e-6), for float32 sums taken in another order through 4 layers
and 10 Euler steps.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.models.types import CoTObservation as JaxObservation  # noqa: E402
from lap_tpu_torch.models.convert import load_jax_params  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from lap_tpu_torch.models.types import CoTObservation  # noqa: E402
from lap_tpu_torch.policies.policy import Policy  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TORCH_THREADS,
    random_obs_arrays,
    randomize_params,
    tiny_lap_config_kwargs,
)

torch.set_num_threads(TORCH_THREADS)
GOLDEN = Path(__file__).parent / "golden" / "sample_actions_tiny.npz"
TOL = dict(atol=2e-5, rtol=2e-5)


def _jax_model(attn_impl):
    cfg = JaxLAPConfig(**tiny_lap_config_kwargs(attn_impl=attn_impl, enable_langact_training=True))
    return cfg, cfg.create_module()


def _port_model(attn_impl, params):
    model = LAP(LAPConfig(**tiny_lap_config_kwargs(attn_impl=attn_impl)), device="cpu", init_seed=None)
    return load_jax_params(model, params)


@pytest.fixture(scope="module")
def random_params():
    cfg, model = _jax_model("xla")
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=model.init_params_fn)
    )
    return randomize_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 21)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_sample_actions_batch2_matches_jax(random_params, attn_impl):
    cfg_kw = tiny_lap_config_kwargs()
    arrays = random_obs_arrays(22, batch=2, valid=[11, 5], cfg_kw=cfg_kw)
    noise = np.random.default_rng(23).standard_normal((2, 4, 7)).astype(np.float32)

    _, jmodel = _jax_model(attn_impl)
    jobs = JaxObservation(**{k: jax.tree.map(jnp.asarray, v) for k, v in arrays.items()})
    sample = jax.jit(
        lambda p, o, n: jmodel.apply(p, jax.random.PRNGKey(0), o, noise=n, method=jmodel.sample_actions)
    )
    # On the CPU the Pallas flash kernel runs in interpret mode by itself
    # (flash_attention._interpret), as the JAX package's own tests run it.
    ref = np.asarray(sample({"params": random_params}, jobs, jnp.asarray(noise)))

    port = _port_model(attn_impl, random_params)
    pobs = CoTObservation(
        images={k: torch.from_numpy(v) for k, v in arrays["images"].items()},
        image_masks={k: torch.from_numpy(v) for k, v in arrays["image_masks"].items()},
        **{k: torch.from_numpy(arrays[k]) for k in
           ("state", "tokenized_prompt", "tokenized_prompt_mask", "tokenized_langact_mask")},
    )
    got = port.sample_actions(pobs, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == (2, 4, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    # The padding changes the answer: the two rows must not coincide.
    assert np.abs(got[0] - got[1]).max() > 1e-3


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden fixture not generated")
def test_reproduces_golden_sample_actions_from_jax_init():
    """tests/golden/sample_actions_tiny.npz from JAX's own init (PRNGKey 0)."""
    cfg, jmodel = _jax_model("auto")
    params = jax.jit(lambda r: jmodel.init(r, r, method=jmodel.init_params_fn))(jax.random.PRNGKey(0))
    port = _port_model("auto", jax.tree.map(np.asarray, params))
    # The port's fake_obs is the same all-zero observation as JAX's.
    pobs = port.config.fake_obs(1, device="cpu")
    noise = np.linspace(-1, 1, cfg.action_horizon * cfg.action_dim, dtype=np.float32)
    noise = noise.reshape(1, cfg.action_horizon, cfg.action_dim)
    got = port.sample_actions(pobs, num_steps=10, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, np.load(GOLDEN)["actions"], **TOL)
    jobs = cfg.fake_obs(1)
    for name in ("state", "tokenized_prompt", "tokenized_prompt_mask", "tokenized_langact_mask"):
        np.testing.assert_array_equal(getattr(pobs, name).numpy(), np.asarray(getattr(jobs, name)))


def test_policy_infer_is_seeded_per_request(random_params):
    port = _port_model("xla", random_params)
    cfg_kw = tiny_lap_config_kwargs()
    arrays = random_obs_arrays(24, batch=1, valid=[7], cfg_kw=cfg_kw)
    request = {
        "image": {k: ((v[0] + 1) * 127.5).astype(np.uint8) for k, v in arrays["images"].items()},
        "state": arrays["state"][0],
        "tokenized_prompt": arrays["tokenized_prompt"][0],
        "tokenized_prompt_mask": arrays["tokenized_prompt_mask"][0],
    }
    first = Policy(port, seed=3).infer(request)
    again = Policy(port, seed=3)
    a1, a2 = again.infer(request)["actions"], again.infer(request)["actions"]
    assert first["actions"].shape == (4, 7) and "infer_ms" in first["policy_timing"]
    np.testing.assert_array_equal(first["actions"], a1)  # same seed, same step
    assert np.abs(a1 - a2).max() > 1e-4  # the next request draws new noise


def test_token_bucket_trims_like_jax_and_keeps_actions(random_params):
    from lap_tpu.policies.policy import _trim_token_pad as jax_trim
    from lap_tpu_torch.policies.policy import _trim_token_pad

    port = _port_model("xla", random_params)
    arrays = random_obs_arrays(25, batch=1, valid=[5], cfg_kw=tiny_lap_config_kwargs())
    request = {
        "image": {k: ((v[0] + 1) * 127.5).astype(np.uint8) for k, v in arrays["images"].items()},
        "state": arrays["state"][0],
        "tokenized_prompt": arrays["tokenized_prompt"][0],
        "tokenized_prompt_mask": arrays["tokenized_prompt_mask"][0],
    }
    batch = {k: np.asarray(v)[None] for k, v in request.items() if k != "image"}
    got, ref = _trim_token_pad(batch, 8), jax_trim(batch, 8)
    assert got.keys() == ref.keys() and got["tokenized_prompt"].shape == (1, 8)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    full = Policy(port, seed=4).infer(request)["actions"]
    trimmed = Policy(port, seed=4, token_bucket=8).infer(request)["actions"]
    np.testing.assert_allclose(trimmed, full, **TOL)  # padded keys carry no weight
