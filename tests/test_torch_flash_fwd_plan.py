"""The flash forward kernel's launch plan, and its wrapper on the CPU.

``flash_attention.forward_plan`` sizes the forward kernel
(``csrc/flash_attention_fwd.cu``) from the shapes alone and mirrors the
source's constants: the plan checks are arithmetic on shapes, exact. On the
CPU ``flash_attention_forward`` takes the plain version and launches
nothing; on the masks of the serving prefills (the flow prefix, the
right-aligned AR prefill with leading dead rows and masked decode slots) it
must equal the Pallas forward (``_flash_forward`` in interpret mode, f32) to
2e-5, the tolerance of ``test_torch_ops.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lap_tpu.ops.flash_attention import _flash_forward  # noqa: E402
from lap_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / fa.SOURCE
PREFILL = (1, 692, 692, 8, 1, 256)  # LAP-3B serving prefill
AR_PREFILL = (1, 692, 756, 8, 1, 256)  # the right-aligned AR prefill, 64 decode slots
TRAINING = (8, 692, 708, 8, 1, 256)  # the LAP-3B training call


def test_plan_constants_mirror_the_cuda_source():
    text = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["FWD_WARPS"]) == fa.FWD_WARPS
    assert int(consts["FWD_BLOCK_N"]) == fa.FWD_BLOCK_N
    assert int(consts["FWD_STAGES"]) == fa.FWD_STAGES
    assert "FWD_BLOCK_M = 16 * FWD_WARPS;" in text and fa.FWD_BLOCK_M == 16 * fa.FWD_WARPS
    assert "FWD_THREADS = CONSUMER_THREADS + 128;" in text and fa.FWD_THREADS == 32 * fa.FWD_WARPS + 128
    assert "MASK_LD = FWD_BLOCK_N + 16;" in text and fa.FWD_MASK_LD == fa.FWD_BLOCK_N + 16
    assert "+ 64 + SMEM_ALIGN;" in text and int(consts["SMEM_ALIGN"]) + 64 == fa.FWD_SMEM_EXTRA
    # The kernel's grid is the plan's: a block a 128-row tile of one (head, batch).
    assert "dim3 grid((p.T + FWD_BLOCK_M - 1) / FWD_BLOCK_M, p.N, p.B);" in text


@pytest.mark.parametrize(
    "shape,grid,waves",
    [(PREFILL, (6, 8, 1), 48 / 132), (AR_PREFILL, (6, 8, 1), 48 / 132), (TRAINING, (6, 8, 8), 384 / 132)],
    ids=["flow_prefill", "ar_prefill", "training"],
)
def test_plan_at_the_paths_shapes(shape, grid, waves):
    b, t, s, n, kh, h = shape
    plan = fa.forward_plan(*shape)
    assert plan["grid"] == grid and plan["blocks"] == int(np.prod(grid))
    assert plan["key_tiles"] == -(-s // 64)
    assert plan["blocks_per_sm"] == 1 and plan["threads"] == 384
    assert plan["waves"] == pytest.approx(waves, rel=1e-12)


@pytest.mark.parametrize("b,n,h", [(1, 8, 256), (1, 8, 128), (2, 4, 256), (3, 1, 128)])
def test_plan_covers_every_row_and_key_once(b, n, h):
    """For T, S = 1 .. 2000: the row tiles cover T with less than one tile
    to spare, the key tiles cover S likewise."""
    for length in range(1, 2001):
        plan = fa.forward_plan(b, length, length, n, 1, h)
        rows, keys = plan["grid"][0] * fa.FWD_BLOCK_M, plan["key_tiles"] * fa.FWD_BLOCK_N
        assert length <= rows < length + fa.FWD_BLOCK_M and length <= keys < length + fa.FWD_BLOCK_N
        assert plan["grid"][1:] == (n, b) and plan["blocks"] == plan["grid"][0] * n * b


@pytest.mark.parametrize("h", [128, 256])
def test_shared_memory_fits_a_block(h):
    plan = fa.forward_plan(1, 692, 692, 8, 1, h)
    stage = 2 * fa.FWD_BLOCK_N * h * 2 + fa.FWD_BLOCK_M * fa.FWD_MASK_LD
    assert plan["smem"] == fa.FWD_BLOCK_M * h * 2 + fa.FWD_STAGES * stage + 64 + 1024
    assert plan["smem"] <= fa.BLOCK_SHARED_MAX
    assert plan["blocks_per_sm"] == 1


def test_plan_raises_on_shapes_the_kernel_cannot_take():
    for bad in ((1, 8, 8, 4, 1, 72), (1, 0, 8, 4, 1, 128), (1, 8, 8, 6, 4, 128)):
        with pytest.raises(ValueError):
            fa.forward_plan(*bad)


def _qkv(seed, b, t, s, n, kh, h):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, n, h), (b, s, kh, h), (b, s, kh, h)))


def _prefix_lm(b, t, s, valid, causal_tail):
    """[b, t, s] prefix-LM mask: ``valid`` real tokens, the last
    ``causal_tail`` of them causal, padding rows fully masked."""
    q = np.arange(t)[:, None]
    k = np.arange(s)[None, :]
    live = (q < valid) & (k < valid)
    return np.broadcast_to(live & ((k < valid - causal_tail) | (k <= q)), (b, t, s)).copy()


def _right_aligned(b, t, valid, causal_tail, decode_slots):
    """The prefix-LM mask moved to the right (its padding rows and keys
    first, fully masked) and padded with masked decode slots, as the AR
    prefill passes it: [b, t, t + decode_slots]."""
    mask = np.roll(_prefix_lm(b, t, t, valid, causal_tail), (t - valid, t - valid), axis=(1, 2))
    return np.pad(mask, ((0, 0), (0, 0), (0, decode_slots)))


PREFILL_MASKS = [
    # name, (b, t, s, n, kh, h), mask
    ("flow_prefix", (1, 40, 40, 4, 1, 32), _prefix_lm(1, 40, 40, 31, 9)),
    ("ar_right_aligned", (1, 40, 52, 4, 1, 32), _right_aligned(1, 40, 29, 7, 12)),
    ("ar_right_aligned_gqa", (2, 24, 30, 4, 2, 16), _right_aligned(2, 24, 17, 5, 6)),
]


@pytest.mark.parametrize("case", PREFILL_MASKS, ids=[c[0] for c in PREFILL_MASKS])
def test_cpu_forward_matches_the_pallas_forward_on_prefill_masks(case):
    """Dead rows (the padding) give zeros and lse -2.3819763e38, as in JAX;
    the wrapper launches nothing on CPU tensors."""
    _, (b, t, s, n, kh, h), mask = case
    q, k, v = _qkv(3, b, t, s, n, kh, h)
    scale = h**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = _flash_forward(
            jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)),
            jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(mask), scale, 8, 8,
        )
    before = fa.launches
    out, lse = fa.flash_attention_forward(*map(torch.from_numpy, (q, k, v, mask)), scale=scale)
    assert fa.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out).transpose(0, 2, 1, 3), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5, rtol=2e-5)
    dead = ~mask.any(-1)  # [b, t]
    assert dead.any()
    assert np.all(out.numpy()[dead] == 0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[dead] == fa.MASK_VALUE)


def test_wrapper_launches_nothing_on_the_cpu():
    q, k, v = _qkv(6, 1, 300, 300, 8, 1, 128)
    mask = _prefix_lm(1, 300, 300, 250, 20)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    before = fa.launches
    out, lse = fa.flash_attention_forward(tq, tk, tv, tm)
    ref, ref_lse = fa.flash_attention_plain(tq, tk, tv, tm)
    assert fa.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
