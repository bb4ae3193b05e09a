"""Parity of the port's ops (lap_tpu_torch.ops) with lap_tpu.ops on the CPU.

Tolerances: f32 on both sides; the einsum paths agree to float32 rounding
(atol 1e-5); the flash plain version against the Pallas kernel, which runs in
interpret mode and sums its online softmax per KV block, to atol 2e-5.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lap_tpu.ops import apply_rope as jax_rope  # noqa: E402
from lap_tpu.ops import make_attn_mask as jax_mask  # noqa: E402
from lap_tpu.ops import bidirectional_block_mask as jax_bidir  # noqa: E402
from lap_tpu.ops import combine_masks as jax_combine  # noqa: E402
from lap_tpu.ops import sliding_window_mask as jax_window  # noqa: E402
from lap_tpu.ops import xla_attention as jax_xla  # noqa: E402
from lap_tpu.ops.flash_attention import _flash_forward  # noqa: E402
from lap_tpu_torch.ops import attention as port_attention  # noqa: E402
from lap_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from lap_tpu_torch.ops import masks  # noqa: E402
from lap_tpu_torch.ops.masks import make_attn_mask  # noqa: E402
from lap_tpu_torch.ops.rope import apply_rope  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def _qkv(seed, b, t, s, n, kh, h):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, n, h)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, h)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, h)).astype(np.float32)
    return q, k, v


def _mask(seed, b, t, s, density=0.6, dead_rows=0):
    rng = np.random.default_rng(seed)
    m = rng.random((b, t, s)) < density
    if dead_rows:
        m[:, rng.choice(t, dead_rows, replace=False), :] = False
    return m


def test_make_attn_mask_matches_jax():
    rng = np.random.default_rng(0)
    input_mask = rng.random((3, 11)) < 0.8
    mask_ar = rng.random((3, 11)) < 0.3
    ref = np.asarray(jax_mask(jnp.asarray(input_mask), jnp.asarray(mask_ar)))
    got = make_attn_mask(torch.from_numpy(input_mask), torch.from_numpy(mask_ar)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_other_masks_match_jax():
    rng = np.random.default_rng(10)
    qpos = rng.integers(0, 30, (2, 7)).astype(np.int32)
    kpos = rng.integers(0, 30, (2, 9)).astype(np.int32)
    qf, kf = rng.random((2, 7)) < 0.5, rng.random((2, 9)) < 0.5
    j, t = jnp.asarray, torch.from_numpy
    window = masks.sliding_window_mask(t(qpos), t(kpos), 5).numpy()
    np.testing.assert_array_equal(window, np.asarray(jax_window(j(qpos), j(kpos), 5)))
    bidir = masks.bidirectional_block_mask(t(qf), t(kf)).numpy()
    np.testing.assert_array_equal(bidir, np.asarray(jax_bidir(j(qf), j(kf))))
    combined = masks.combine_masks(None, t(window), t(bidir), None).numpy()
    np.testing.assert_array_equal(combined, np.asarray(jax_combine(None, j(window), j(bidir), None)))
    assert masks.combine_masks(None, None) is None


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 700, (2, 7)).astype(np.int32)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,kh,dead_rows", [(4, 1, 0), (4, 2, 0), (4, 4, 3)])
def test_xla_attention_matches_jax(n, kh, dead_rows):
    q, k, v = _qkv(2, 2, 9, 13, n, kh, 16)
    mask = _mask(3, 2, 9, 13, dead_rows=dead_rows)
    ref = np.asarray(jax_xla(*map(jnp.asarray, (q, k, v, mask)), scale=0.3))
    got = port_attention.xla_attention(*map(torch.from_numpy, (q, k, v, mask)), scale=0.3).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# (b, t, s, n, kh, h, block_q, block_kv, dead_rows): GQA group 1 and 4,
# fully masked rows, T/S that are not block multiples, several KV blocks.
FLASH_CASES = [
    (1, 24, 40, 4, 4, 32, 16, 16, 0),
    (2, 19, 37, 4, 1, 32, 16, 16, 4),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(case):
    b, t, s, n, kh, h, block_q, block_kv, dead = case
    q, k, v = _qkv(4, b, t, s, n, kh, h)
    mask = _mask(5, b, t, s, dead_rows=dead)
    scale = h**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = _flash_forward(
            jnp.asarray(q.transpose(0, 2, 1, 3)),
            jnp.asarray(k.transpose(0, 2, 1, 3)),
            jnp.asarray(v.transpose(0, 2, 1, 3)),
            jnp.asarray(mask),
            scale,
            block_q,
            block_kv,
        )
    out, lse = port_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v, mask)), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out).transpose(0, 2, 1, 3), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5, rtol=2e-5)
    if dead:
        dead_rows = ~mask.any(-1)
        assert np.all(out.numpy()[dead_rows] == 0)
        assert np.all(lse.numpy().transpose(0, 2, 1)[dead_rows] == port_flash.MASK_VALUE)


def test_flash_wrapper_takes_plain_version_on_cpu():
    q, k, v = _qkv(6, 1, 8, 8, 4, 1, 128)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, _mask(7, 1, 8, 8)))
    before = port_flash.launches
    out = port_flash.flash_attention(tq, tk, tv, tm)
    ref, _ = port_flash.flash_attention_plain(tq, tk, tv, tm)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert port_flash.launches == before


def test_flash_kernel_rejects_what_it_does_not_take():
    q = torch.zeros((1, 8, 4, 72), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 72), dtype=torch.bfloat16)
    mask = torch.ones((1, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="head dims"):
        port_flash._launch(q, k, k, mask, 1.0)
    q = torch.zeros((1, 8, 4, 128), dtype=torch.float32)
    k = torch.zeros((1, 8, 1, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        port_flash._launch(q, k, k, mask, 1.0)


@pytest.mark.parametrize(
    "is_cuda,t,h,expected",
    [
        (True, 692, 256, True),  # the LAP-3B prefill
        (True, 16, 256, False),  # a flow-suffix step
        (True, 256, 72, False),  # SigLIP So400m
        (True, 384, 128, True),
        (False, 692, 256, False),  # CPU tensors take the einsum path, as JAX on CPU
    ],
)
def test_auto_rule(is_cuda, t, h, expected):
    q = SimpleNamespace(is_cuda=is_cuda, shape=(1, t, 8, h))
    assert port_attention.use_flash(q) is expected


def test_auto_on_cpu_is_the_einsum_path():
    q, k, v = _qkv(8, 1, 200, 200, 2, 1, 128)
    args = [*map(torch.from_numpy, (q, k, v)), torch.from_numpy(_mask(9, 1, 200, 200))]
    got = port_attention.attention(*args, impl="auto")
    torch.testing.assert_close(got, port_attention.xla_attention(*args), atol=0, rtol=0)
