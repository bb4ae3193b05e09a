"""The backward's pieces outside the gradient kernels, on the CPU.

``flash_attention_delta_plain`` (what the delta kernel computes) against the
``delta`` of lap_tpu's ``_flash_backward`` (``jnp.sum(do * out)`` in f32),
tolerance 2e-6 for f32 sums of 16-32 products taken in another order; the
GQA group sum's plain version against a float64 sum; and the wrapper's launch
plan, which mirrors the constants of ``csrc/flash_attention_bwd.cu``: the
group-sum scratch and pass only for a group above 1, and every kernel within
one block's 227 KB of shared memory with two blocks on an SM.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.ops import flash_attention as jax_flash  # noqa: E402
from lap_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

# The LAP-3B training call: B=8, T=692 queries, S=708 keys, 8 query heads.
TRAIN = dict(b=8, t=692, s=708, n=8)


def _jax_delta(out_bnth, dout_bnth):
    """The expression of ``_flash_backward`` (lap_tpu/ops/flash_attention.py)."""
    return jnp.sum(jnp.asarray(dout_bnth).astype(jnp.float32) * jnp.asarray(out_bnth).astype(jnp.float32),
                   axis=-1)


@pytest.mark.parametrize("b,t,n,h", [(1, 24, 4, 32), (2, 19, 8, 16), (2, 37, 2, 32)])
def test_delta_plain_matches_the_jax_reference(b, t, n, h):
    rng = np.random.default_rng(50 + t)
    out = rng.standard_normal((b, t, n, h)).astype(np.float32)
    dout = rng.standard_normal((b, t, n, h)).astype(np.float32)
    out[:, 3] = 0.0  # a fully masked row's output
    ref = _jax_delta(out.transpose(0, 2, 1, 3), dout.transpose(0, 2, 1, 3))  # JAX layout [B,N,T,H]
    got = port_flash.flash_attention_delta_plain(torch.from_numpy(out), torch.from_numpy(dout))
    assert got.shape == (b, n, t) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=2e-6)
    assert np.all(got.numpy()[:, :, 3] == 0.0)


def test_delta_takes_the_plain_version_on_cpu_and_launches_nothing():
    rng = np.random.default_rng(51)
    out, dout = (torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(np.float32)).to(torch.bfloat16)
                 for _ in range(2))
    before = port_flash.launches_bwd_delta
    got = port_flash.flash_attention_delta(out, dout[:, :, :, :])
    assert port_flash.launches_bwd_delta == before
    torch.testing.assert_close(got, port_flash.flash_attention_delta_plain(out, dout), atol=0, rtol=0)


@pytest.mark.parametrize("kh", [1, 2, 8])
def test_group_sum_plain_adds_the_heads_of_each_group(kh):
    """dk/dv[b, s, kh, h] = bf16(sum over the group's heads, in head order)."""
    rng = np.random.default_rng(52)
    partial = rng.standard_normal((2, 2, 5, 8, 16)).astype(np.float32)
    before = port_flash.launches_bwd_group_sum
    dk, dv = port_flash.flash_attention_group_sum(torch.from_numpy(partial), kh)
    assert port_flash.launches_bwd_group_sum == before  # CPU: the plain version
    ref = partial.astype(np.float64).reshape(2, 2, 5, kh, 8 // kh, 16).sum(axis=4)
    for got, want in zip((dk, dv), ref, strict=True):
        assert got.dtype == torch.bfloat16 and got.shape == (2, 5, kh, 16)
        # f32 sums of at most 8 terms, then one bf16 rounding.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("h", [128, 256])
def test_backward_plan_fits_two_blocks_per_sm(h, group):
    plan = port_flash.backward_plan(TRAIN["b"], TRAIN["t"], TRAIN["s"], TRAIN["n"], TRAIN["n"] // group, h)
    assert plan["group"] == group
    # The group-sum pass and its f32 scratch [2, B, S, N, H] only above group 1.
    assert plan["group_sum"] == (group > 1)
    assert plan["scratch_shape"] == ((2, TRAIN["b"], TRAIN["s"], TRAIN["n"], h) if group > 1 else None)
    # One block per (64 queries, head, batch) for dQ and per (32 keys, query
    # head, batch) for dK/dV: 704 and 1,472 blocks at the training shape.
    assert plan["dq_grid"] == (11, TRAIN["n"], TRAIN["b"])
    assert plan["dkv_grid"] == (23, TRAIN["n"], TRAIN["b"])
    for name in ("dq", "dkv"):
        smem = plan[name + "_smem"]
        assert smem <= 227 * 1024  # what one block may take
        assert plan[name + "_blocks_per_sm"] >= 2
        assert 2 * (smem + port_flash.BLOCK_RESERVED_SHARED) <= port_flash.SM_SHARED_BYTES


def test_backward_on_cpu_launches_no_kernel_and_matches_the_plain_backward():
    rng = np.random.default_rng(53)
    b, t, s, n, kh, h = 2, 13, 17, 8, 2, 16
    q, dout = (torch.from_numpy(rng.standard_normal((b, t, n, h)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kh, h)).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((b, t, s)) < 0.6)
    out, lse = port_flash.flash_attention_forward(q, k, v, mask)
    counters = ("launches", "launches_bwd_dq", "launches_bwd_dkv", "launches_bwd_delta", "launches_bwd_group_sum")
    before = [getattr(port_flash, c) for c in counters]
    got = port_flash.flash_attention_backward(q, k, v, mask, out, lse, dout)
    assert [getattr(port_flash, c) for c in counters] == before
    want = port_flash.flash_attention_backward_plain(q, k, v, mask, out, lse, dout)
    for a, w in zip(got, want, strict=True):
        torch.testing.assert_close(a, w, atol=0, rtol=0)
