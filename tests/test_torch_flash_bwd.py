"""The plain flash-attention backward against lap_tpu's Pallas backward.

``flash_attention_backward_plain`` (the formulas the CUDA kernels implement,
in f32) is held against ``jax.vjp`` of ``lap_tpu.ops.flash_attention``, whose
Pallas dQ and dK/dV kernels run in interpret mode on the CPU, and against
autograd through ``flash_attention_plain``. f32 on both sides; tolerance
atol/rtol 2e-5 for sums taken per block in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from lap_tpu_torch.ops import flash_attention as port_flash  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
TOL = dict(atol=2e-5, rtol=2e-5)

# (b, t, s, n, kh, h, dead_rows, dead_cols): GQA group 1 and 4, ragged T/S
# across several Pallas blocks of 16, fully masked rows, all-false key columns.
CASES = [
    (1, 24, 40, 4, 4, 32, 0, 0),
    (2, 19, 37, 4, 1, 32, 4, 0),
    (2, 21, 30, 8, 2, 16, 3, 5),
]


def _inputs(case, seed=40):
    b, t, s, n, kh, h, dead_rows, dead_cols = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, n, h)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, h)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, h)).astype(np.float32)
    dout = rng.standard_normal((b, t, n, h)).astype(np.float32)
    mask = rng.random((b, t, s)) < 0.6
    if dead_rows:
        mask[:, rng.choice(t, dead_rows, replace=False), :] = False
    if dead_cols:
        mask[:, :, rng.choice(s, dead_cols, replace=False)] = False
    return q, k, v, mask, dout


def _port_grads(q, k, v, mask, dout, scale):
    tq, tk, tv, tm, tdo = map(torch.from_numpy, (q, k, v, mask, dout))
    out, lse = port_flash.flash_attention_plain(tq, tk, tv, tm, scale=scale)
    return port_flash.flash_attention_backward_plain(tq, tk, tv, tm, out, lse, tdo, scale)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_backward(case):
    q, k, v, mask, dout = _inputs(case)
    scale = 0.3
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, jnp.asarray(mask), scale=scale, block_q=16, block_kv=16),
        *map(jnp.asarray, (q, k, v)),
    )
    refs = vjp(jnp.asarray(dout))
    grads = _port_grads(q, k, v, mask, dout, scale)
    for got, ref in zip(grads, refs, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    dead_rows, dead_cols = ~mask.any(-1), ~mask.any(-2)
    assert np.all(grads[0].numpy()[dead_rows] == 0)
    assert np.all(grads[1].numpy()[dead_cols] == 0) and np.all(grads[2].numpy()[dead_cols] == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    q, k, v, mask, dout = _inputs(case, seed=41)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = port_flash.flash_attention_plain(tq, tk, tv, torch.from_numpy(mask), scale=0.3)
    refs = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for got, ref in zip(_port_grads(q, k, v, mask, dout, 0.3), refs, strict=True):
        torch.testing.assert_close(got, ref, **TOL)


def test_flash_attention_is_differentiable_and_takes_the_plain_backward_on_cpu():
    """The autograd Function: gradients on CPU tensors equal the plain
    backward's, launch no kernel, and skip what needs no gradient."""
    q, k, v, mask, dout = _inputs(CASES[1], seed=42)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (port_flash.launches, port_flash.launches_bwd_dq, port_flash.launches_bwd_dkv)
    out = port_flash.flash_attention(tq, tk, tv, torch.from_numpy(mask), scale=0.3)
    out.backward(torch.from_numpy(dout))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), _port_grads(q, k, v, mask, dout, 0.3), strict=True):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert (port_flash.launches, port_flash.launches_bwd_dq, port_flash.launches_bwd_dkv) == before
    # Detached keys and values (the stop-gradient call) get no gradient.
    tq2 = torch.from_numpy(q).requires_grad_()
    out2 = port_flash.flash_attention(tq2, tk.detach(), tv.detach(), torch.from_numpy(mask), scale=0.3)
    out2.backward(torch.from_numpy(dout))
    torch.testing.assert_close(tq2.grad, tq.grad, atol=0, rtol=0)


def test_backward_launch_rejects_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 128), dtype=torch.bfloat16)
    mask = torch.ones((1, 8, 8), dtype=torch.bool)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="output gradient"):
        port_flash._launch_backward(q, k, k, mask, q, lse, q.float(), 1.0)
    with pytest.raises(ValueError, match="head dims"):
        q72 = torch.zeros((1, 8, 4, 72), dtype=torch.bfloat16)
        port_flash._launch_backward(q72, q72[:, :, :1], q72[:, :, :1], mask, q72, lse, q72, 1.0)
