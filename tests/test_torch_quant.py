"""Quantized serving in the port against lap_tpu on the CPU.

- ``quantize_int8``/``quantize_int4`` are bit-equal to JAX's under ``jit``
  (where the JAX package quantizes; XLA turns ``absmax / 127`` into a product
  with the reciprocal) on the same numpy weights (a zero column / group takes
  scale 1.0; exact .5 ties round to even), and ``unpack_nibbles`` agrees on
  all 256 byte values.
- The plain dequant matmuls match ``int8_matmul_reference`` /
  ``int4_matmul_reference`` and the Pallas kernels in interpret mode: f32
  activations to 2e-6 of the output's largest entry (float32 sums taken in
  another order), bf16 activations within one bf16 ulp (2^-8 relative) plus
  2e-6 of the largest entry, since the f32 sum may round to either side.
- The quantized ``Einsum``/``FeedForward`` match JAX's with
  ``quant="int8"``/``"int4"`` (``QUANT_MIN_WEIGHT_ELEMS`` patched on both
  sides): the buffers bit for bit, the outputs to 1e-5 of their largest
  entry, and a call of more than ``QUANT_MAX_ROWS`` rows takes the exact
  product on both sides.
- The port's ``LAP.quantize_`` equals JAX's "quant" collection carried by
  ``load_jax_quant``, bit for bit; the bridge fails on a leftover leaf, an
  unfilled buffer or a shape mismatch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.models import lora as jax_lora  # noqa: E402
from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig  # noqa: E402
from lap_tpu.ops import int4_matmul as jax_int4  # noqa: E402
from lap_tpu.ops import int8_matmul as jax_int8  # noqa: E402
from lap_tpu_torch.models import convert  # noqa: E402
from lap_tpu_torch.models import lora  # noqa: E402
from lap_tpu_torch.models.lap_model import LAP, LAPConfig  # noqa: E402
from lap_tpu_torch.ops import int4_matmul as int4  # noqa: E402
from lap_tpu_torch.ops import int8_matmul as int8  # noqa: E402
from torch_port_helpers import TORCH_THREADS, flatten, randomize_params, tiny_lap_config_kwargs, unflatten  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
SMALL_MIN_ELEMS = 4096  # every dummy-width Einsum/MLP/vocab weight but kv_einsum


@pytest.fixture
def small_threshold(monkeypatch):
    monkeypatch.setattr(jax_lora, "QUANT_MIN_WEIGHT_ELEMS", SMALL_MIN_ELEMS)
    monkeypatch.setattr(lora, "QUANT_MIN_WEIGHT_ELEMS", SMALL_MIN_ELEMS)


def _weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    return w


def test_quantize_int8_bit_equal_to_jax():
    w = _weights(96, 40, 0)
    w[:, 3] = 0.0  # all-zero column: scale 1.0
    w[:, 5] = np.arange(96) % 9 - 4 + 0.5  # absmax 4.5
    w[0, 6], w[1:, 6] = 127.0, np.arange(95) % 7 + 0.5  # scale 1: exact .5 ties round to even
    got_q, got_s = int8.quantize_int8(torch.from_numpy(w))
    ref_q, ref_s = jax.jit(jax_int8.quantize_int8)(jnp.asarray(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert got_q.dtype == torch.int8 and got_s[3].item() == 1.0


def test_quantize_int4_and_unpack_bit_equal_to_jax():
    w = _weights(128, 24, 1)
    w[32:64, 2] = 0.0  # an all-zero group: scale 1.0
    w[:32, 4] = np.concatenate([[7.0], np.arange(31) % 6 - 3 + 0.5])  # scale 1: ties
    got_p, got_s = int4.quantize_int4(torch.from_numpy(w), group_size=32)
    ref_p, ref_s = jax.jit(jax_int4.quantize_int4, static_argnums=1)(jnp.asarray(w), 32)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for got, ref in zip(int4.unpack_nibbles(torch.from_numpy(every_byte)),
                        jax_int4._unpack_nibbles(jnp.asarray(every_byte)), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        int4.quantize_int4(torch.from_numpy(w[:96]), group_size=32)


def _assert_close_to(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    floor = 2e-6 * np.abs(ref).max()
    rel = 2.0**-8 if dtype == "bfloat16" else 0.0
    assert np.all(np.abs(got - ref) <= rel * np.abs(ref) + floor), np.abs(got - ref).max()


def _x(m, k, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype)), jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_int8_plain_matches_reference_and_interpreted_kernel(m, dtype):
    k, n = 256, 200  # N = 200: no 128-multiple, a ragged edge for the kernel's blocks
    w_q, s = jax_int8.quantize_int8(jnp.asarray(_weights(k, n, 2)))
    xt, xj = _x(m, k, dtype, 3)
    got = int8.int8_matmul(xt, torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(s)))
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    _assert_close_to(got, jax_int8.int8_matmul_reference(xj, w_q, s), dtype)
    _assert_close_to(got, jax_int8.int8_matmul(xj, w_q, s, force_kernel=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_int4_plain_matches_reference_and_interpreted_kernel(m, dtype):
    k, n = 512, 200
    packed, s = jax_int4.quantize_int4(jnp.asarray(_weights(k, n, 4)), group_size=128)
    xt, xj = _x(m, k, dtype, 5)
    got = int4.int4_matmul(xt, torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(s)))
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    _assert_close_to(got, jax_int4.int4_matmul_reference(xj, packed, s), dtype)
    _assert_close_to(got, jax_int4.int4_matmul(xj, packed, s, force_kernel=True), dtype)


def test_quant_pair_picks_int4_groups_or_falls_back_to_int8():
    assert [lora._int4_group(k) for k in (2048, 16384, 64, 48)] == [256, 256, 32, None]
    for k in (128, 48):  # 48 fits no int4 group: int8 per channel
        w = _weights(k, 16, k)
        got = lora._quant_pair(torch.from_numpy(w), (0, 1), 1, "int4")
        ref = jax.jit(jax_lora._quant_pair, static_argnums=(1, 2, 3))(jnp.asarray(w), (0, 1), 1, "int4")
        assert got[1].dim() == np.asarray(ref[1]).ndim == (2 if k == 128 else 1)
        for a, b in zip(got, ref, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (JAX equation, the port's, weight shape) for the q, kv and attn_vec projections.
EINSUMS = [
    ("BTD,NDH->BTNH", "btd,ndh->btnh", (8, 64, 16)),
    ("BSD,2KDH->2BSKH", "bsd,cndh->cbsnh", (2, 2, 64, 32)),
    ("BTNH,NHD->BTD", "btnh,nhd->btd", (8, 16, 64)),
]


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("jax_eqn,eqn,shape", EINSUMS, ids=["q", "kv", "attn_vec"])
def test_quantized_einsum_matches_jax(small_threshold, mode, jax_eqn, eqn, shape):
    rng = np.random.default_rng(6)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    x_shape = (2, 3, 64) if eqn[0:4] != "btnh" else (2, 3, 8, 16)
    jmod = jax_lora.Einsum(shape=shape, init_fn=fnn.initializers.zeros, quant=mode)
    port = lora.Einsum(shape, eqn, 64)
    with torch.no_grad():
        port.w.copy_(torch.from_numpy(w))
    port.quantize_(mode)
    for rows in (3, 70):  # 2*3 rows take the dequant matmul; 140 > QUANT_MAX_ROWS the exact einsum
        x = rng.standard_normal((2, rows, *x_shape[2:])).astype(np.float32)
        ref, qvars = jax.jit(lambda p, x_: jmod.apply(p, jax_eqn, x_, mutable=["quant"]))(
            {"params": {"w": jnp.asarray(w)}}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5 * np.abs(np.asarray(ref)).max())
        buffers = dict(port.named_buffers())
        assert set(buffers) == set(qvars["quant"])
        for name, value in qvars["quant"].items():
            np.testing.assert_array_equal(buffers[name].numpy(), np.asarray(value))
    exact = torch.einsum(eqn, torch.from_numpy(x), port.w.detach())
    np.testing.assert_array_equal(got, exact.numpy())  # 140 rows: the exact product


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_feed_forward_matches_jax(small_threshold, mode):
    rng = np.random.default_rng(7)
    gating = (rng.standard_normal((2, 64, 128)) * 0.1).astype(np.float32)
    linear = (rng.standard_normal((128, 64)) * 0.1).astype(np.float32)
    params = {"params": {"gating_einsum": jnp.asarray(gating), "linear": jnp.asarray(linear)}}
    jmod = jax_lora.FeedForward(features=64, hidden_dim=128, quant=mode)
    port = lora.FeedForward(64, 128)
    with torch.no_grad():
        port.gating_einsum.copy_(torch.from_numpy(gating))
        port.linear.copy_(torch.from_numpy(linear))
    port.quantize_(mode)
    for rows in (4, 65):
        x = rng.standard_normal((2, rows, 64)).astype(np.float32)
        ref, qvars = jax.jit(lambda p, x_: jmod.apply(p, x_, mutable=["quant"]))(params, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5 * np.abs(np.asarray(ref)).max())
        buffers = dict(port.named_buffers())
        assert set(buffers) == set(qvars["quant"]) == {f"{p}{n}" for p in ("gating_", "linear_")
                                                       for n in ("w_i4" if mode == "int4" else "w_i8", "scale")}
        for name, value in qvars["quant"].items():
            np.testing.assert_array_equal(buffers[name].numpy(), np.asarray(value))
    port.quantize_(None)
    assert not dict(port.named_buffers())


@pytest.fixture(scope="module")
def jax_quantized():
    """The dummy LAP in JAX's quantized serving layout (``scan_layers=False``)
    with randomised parameters, and its "quant" collection in both modes."""
    saved = jax_lora.QUANT_MIN_WEIGHT_ELEMS
    jax_lora.QUANT_MIN_WEIGHT_ELEMS = SMALL_MIN_ELEMS
    try:
        out = {}
        for mode in ("int8", "int4"):
            cfg = JaxLAPConfig(**tiny_lap_config_kwargs(enable_langact_training=True, scan_layers=False, quant=mode))
            model = cfg.create_module()
            if "params" not in out:
                shapes = jax.eval_shape(
                    lambda m=model: m.init(jax.random.PRNGKey(0), jax.random.PRNGKey(0), method=m.init_params_fn)
                )
                out["params"] = randomize_params(
                    jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 41)
            _, qvars = jax.jit(
                lambda p, m=model: m.apply(p, jax.random.PRNGKey(0), method=m.init_params_fn, mutable=["quant"])
            )({"params": out["params"]})
            out[mode] = jax.tree.map(np.asarray, qvars["quant"])
        return out
    finally:
        jax_lora.QUANT_MIN_WEIGHT_ELEMS = saved


def _port_lap(params):
    model = LAP(LAPConfig(**tiny_lap_config_kwargs()), device="cpu", init_seed=None)
    return convert.load_jax_params(model, params)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_port_quantize_equals_jax_quant_collection(small_threshold, jax_quantized, mode):
    own = _port_lap(jax_quantized["params"])
    own.quantize_(mode)
    carried = convert.load_jax_quant(_port_lap(jax_quantized["params"]), jax_quantized[mode])
    own_buffers, carried_buffers = dict(own.named_buffers()), dict(carried.named_buffers())
    assert set(own_buffers) == set(carried_buffers)
    quant = {k: v for k, v in own_buffers.items() if k.rsplit(".", 1)[-1].endswith(("w_i8", "w_i4", "scale"))}
    # 4 layers x (q, attn_vec, gating, linear) x 2 experts + the vocab head, each a pair.
    assert len(quant) == 2 * (4 * 4 * 2 + 1)
    for name, value in quant.items():
        assert value.dtype == carried_buffers[name].dtype
        np.testing.assert_array_equal(value.numpy(), carried_buffers[name].numpy())
    assert ("llm.embedder.decode_w_i4" in quant) == (mode == "int4")


def test_quant_bridge_rejects_leftover_unfilled_and_misshapen(small_threshold, jax_quantized):
    flat = flatten(jax_quantized["int8"])
    port = _port_lap(jax_quantized["params"])
    extra = dict(flat, **{"llm/layers_0/attn/kv_einsum/w_i8": np.zeros((64, 32), np.int8)})
    with pytest.raises(ValueError, match="unexpected"):
        convert.load_jax_quant(port, unflatten(extra))
    with pytest.raises(ValueError, match="not consumed"):
        convert.from_jax_quant(unflatten(dict(flat, **{"llm/layers_0/attn/bogus/w_i8": np.zeros(1)})))
    missing = {k: v for k, v in flat.items() if k != "llm/layers_2/mlp_1/linear_scale"}
    with pytest.raises(ValueError, match="unfilled"):
        convert.load_jax_quant(port, unflatten(missing))
    bad = dict(flat)
    bad["llm/embedder/decode_scale"] = bad["llm/embedder/decode_scale"][:-1]
    with pytest.raises(ValueError, match="llm.embedder.decode_scale"):
        convert.load_jax_quant(port, unflatten(bad))


def test_config_quant_quantizes_a_seeded_model(small_threshold):
    """``LAPConfig.quant`` quantizes a model built from a seed; ``quantize_(None)``
    drops the copies and leaves the weights."""
    model = LAP(LAPConfig(**tiny_lap_config_kwargs(quant="int4")), device="cpu", init_seed=0)
    names = {n for n, _ in model.named_buffers()}
    assert {"llm.embedder.decode_w_i4", "llm.layers.0.mlp.1.linear_w_i4", "llm.layers.3.attn.q_einsum.0.scale"} <= names
    assert not any("kv_einsum" in n for n in names)  # 2048 elements: below the threshold
    # The kernels read the relaid-out copies as contiguous [K, N] (the vocab head is [V, D] -> [D, V]).
    assert all(b.is_contiguous() for _, b in model.named_buffers())
    weights = {n: p.clone() for n, p in model.named_parameters()}
    model.quantize_(None)
    assert not any(n.endswith(("w_i4", "w_i8", "scale")) for n, _ in model.named_buffers())
    assert all(torch.equal(p, weights[n]) for n, p in model.named_parameters())
