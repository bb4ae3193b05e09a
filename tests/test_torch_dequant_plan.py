"""The dequant kernels' launch plan, on the CPU.

``int8_matmul.launch_plan`` sizes the work of both dequant kernels
(``csrc/int8_matmul.cu``, ``csrc/int4_matmul.cu``) and mirrors the constants
of ``csrc/dequant_matmul_common.cuh``. For every quantized weight shape of
LAP-3B serving, at 1, 16, 100 and 128 rows, the splits must cover the
contraction axis exactly once and in order, every block must fit in one
block's 227 KB of shared memory at the residency the plan assumes, the
split-K arrival counters must have a slot for every tile, and the plan must take the fewest splits
that keep its bytes in flight. Shapes the kernels cannot take raise.
Everything here is arithmetic on shapes: exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.ops import int4_matmul as jax_int4  # noqa: E402
from lap_tpu.ops import int8_matmul as jax_int8  # noqa: E402
from lap_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from lap_tpu_torch.ops import int8_matmul as i8  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

# (K, N) of every quantized weight of LAP-3B serving: q and attn_vec; MLP
# gate/up and down; the vocab head; the action expert's MLP gate/up and down.
QUANT_SHAPES = [(2048, 2048), (2048, 32768), (16384, 2048), (2048, 257152), (1024, 8192), (4096, 1024)]
ROWS = [1, 16, 100, 128]
GROUP = 256  # the int4 group size of the JAX package and the port
HEADER = Path(i8.__file__).resolve().parents[1] / "csrc" / "dequant_matmul_common.cuh"


def _plan(kind, m, k, n, sms=i8.H100_SMS):
    return i8.launch_plan(kind, m, k, n, GROUP if kind == "int4" else None, sms)


def test_plan_constants_mirror_the_cuda_header():
    text = HEADER.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["CHUNK_ROWS"]) == i8.CHUNK_ROWS
    assert int(consts["BLOCK_N"]) == i8.BLOCK_N
    assert int(consts["STAGES"]) == i8.STAGES
    assert int(consts["DQ_MIN_BLOCKS"]) == i8.MIN_BLOCKS_PER_SM
    assert "DQ_THREADS = 32 * COL_GROUPS * CHUNK_STEPS;" in text
    assert 32 * (i8.BLOCK_N // 32) * (i8.CHUNK_ROWS // 16) == i8.THREADS
    assert "ROW_BYTES = BLOCK_N + 16;" in text and i8.ROW_BYTES == i8.BLOCK_N + 16
    assert "W_STAGE_BYTES = CHUNK_ROWS * ROW_BYTES;" in text and i8.W_STAGE_BYTES == i8.CHUNK_ROWS * i8.ROW_BYTES


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", QUANT_SHAPES)
def test_plan_covers_k_once_fits_shared_memory_and_counts_every_tile(kind, m, k, n):
    plan = _plan(kind, m, k, n)
    row_tiles, col_blocks, splits = plan["grid"]
    assert plan["splits"] == splits >= 1
    assert plan["rows_per_tile"] == (8 if m <= 8 else 16)
    assert row_tiles * plan["rows_per_tile"] >= m > (row_tiles - 1) * plan["rows_per_tile"]
    assert col_blocks * i8.BLOCK_N >= n > (col_blocks - 1) * i8.BLOCK_N

    # Split z takes chunks [z * c, (z + 1) * c) of 64 weight rows (int4:
    # packed rows, each feeding contraction rows p and K/2 + p).
    c = plan["chunks_per_split"]
    weight_rows = k if kind == "int8" else k // 2
    covered = np.concatenate([np.arange(z * c * i8.CHUNK_ROWS, (z + 1) * c * i8.CHUNK_ROWS) for z in range(splits)])
    np.testing.assert_array_equal(covered, np.arange(weight_rows))
    if kind == "int4":
        contraction = np.sort(np.concatenate([covered, covered + k // 2]))
        np.testing.assert_array_equal(contraction, np.arange(k))
        # Each 64-row chunk of a half lies inside one scale group.
        assert GROUP % i8.CHUNK_ROWS == 0 and (k // 2) % GROUP == 0

    # Shared memory: the ring's stages, within one block's limit, at the
    # residency the plan counts on.
    halves = 2 if kind == "int4" else 1
    stage = (i8.W_STAGE_BYTES + halves * plan["rows_per_tile"] * i8.ROW_BYTES
             + (i8.SCALE_STAGE_BYTES if kind == "int4" else 0))
    assert plan["smem"] == i8.STAGES * stage <= i8.BLOCK_SHARED_MAX
    assert plan["blocks_per_sm"] == i8.MIN_BLOCKS_PER_SM
    assert plan["blocks_per_sm"] * (plan["smem"] + i8.BLOCK_RESERVED_SHARED) <= i8.SM_SHARED_BYTES
    assert plan["blocks_per_sm"] * i8.THREADS <= 2048  # threads an SM holds
    # After the last chunk the ring holds the four warp parts' f32 sums of
    # the tile, rows padded to 132 floats.
    assert 4 * plan["rows_per_tile"] * (i8.BLOCK_N + 4) * 4 <= plan["smem"]
    # A split keeps the ring full, unless the weight is a single split.
    assert splits == 1 or c >= i8.STAGES - 1

    # One counter per (row tile, column block) when the splits meet in the
    # kernel; the kernel indexes it by blockIdx.y * gridDim.x + blockIdx.x.
    if splits > 1:
        assert plan["counter_slots"] == row_tiles * col_blocks <= i8.COUNTER_SLOTS
        assert plan["partial_shape"] == (splits, m, n)
    else:
        assert plan["counter_slots"] == 0 and plan["partial_shape"] is None


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("k,n", QUANT_SHAPES)
def test_plan_takes_the_fewest_splits_that_keep_its_bytes_in_flight(kind, k, n):
    sms = i8.H100_SMS
    for m in ROWS:
        plan = _plan(kind, m, k, n, sms)
        tiles = plan["grid"][0] * plan["grid"][1]
        weight = tiles * plan["chunks"] * i8.CHUNK_ROWS * i8.BLOCK_N
        want = min(sms * i8.IN_FLIGHT_PER_SM, weight)
        chunks = plan["chunks"]
        allowed = [d for d in range(1, chunks + 1) if chunks % d == 0 and (d == 1 or chunks // d >= i8.STAGES - 1)]
        assert plan["splits"] in allowed
        # Enough in flight, or as many splits as keep each ring full.
        assert plan["in_flight_per_sm"] * sms >= want or plan["splits"] == allowed[-1]
        for fewer in allowed[: allowed.index(plan["splits"])]:
            resident = min(tiles * fewer, sms * plan["blocks_per_sm"])
            depth = min(i8.STAGES - 1, chunks // fewer)
            assert resident * depth * i8.CHUNK_ROWS * i8.BLOCK_N < want


def test_plan_of_the_lap_decode_shapes():
    """The grids (row tiles, column blocks, splits) the chip run times."""
    assert _plan("int8", 1, 2048, 257152)["grid"] == (1, 2009, 1)
    assert _plan("int4", 1, 2048, 257152)["grid"] == (1, 2009, 1)
    assert _plan("int8", 1, 2048, 32768)["grid"] == (1, 256, 1)
    assert _plan("int8", 1, 16384, 2048)["grid"] == (1, 16, 16)
    assert _plan("int4", 16, 16384, 2048)["grid"] == (1, 16, 16)
    assert _plan("int8", 128, 2048, 2048)["grid"] == (8, 16, 2)
    assert _plan("int8", 1, 2048, 2048)["grid"] == (1, 16, 8)  # 4 chunks a split, not 2


@pytest.mark.parametrize(
    "kind,m,k,n,group",
    [
        ("int8", 1, 2048 + 32, 2048, None),  # K not a multiple of 64
        ("int8", 1, 2048, 2048 + 8, None),  # N not a multiple of 16
        ("int8", 0, 2048, 2048, None),  # no rows
        ("int4", 1, 2048, 2048, 32),  # group below 64
        ("int4", 1, 2048, 2048, 96),  # group not a multiple of 64
        ("int4", 1, 2048, 2048, None),  # no group
        ("int4", 1, 2048 + 128, 2048, 256),  # K/2 not a multiple of the group
        ("int4", 1, 2048, 2048 + 8, 256),  # N not a multiple of 16
        ("int2", 1, 2048, 2048, None),  # no such kernel
    ],
)
def test_plan_raises_on_shapes_the_kernels_cannot_take(kind, m, k, n, group):
    with pytest.raises(ValueError):
        i8.launch_plan(kind, m, k, n, group)


@pytest.mark.parametrize("k,n,m", [(512, 256, 3), (1024, 128, 17)])
def test_cpu_wrappers_launch_nothing_and_match_the_jax_references(k, n, m):
    """On CPU tensors the wrappers take the plain versions (no launch, no
    plan) and agree with the JAX package's references on the same quantized
    weights: f32 sums of the same products in another order, 1e-5 of max|ref|."""
    rng = np.random.default_rng(60 + m)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    before = (i8.launches, i4.launches)
    w8, s8 = i8.quantize_int8(torch.from_numpy(w))
    p4, s4 = i4.quantize_int4(torch.from_numpy(w), group_size=GROUP)
    got8 = i8.int8_matmul(torch.from_numpy(x), w8, s8).numpy()
    got4 = i4.int4_matmul(torch.from_numpy(x), p4, s4).numpy()
    assert (i8.launches, i4.launches) == before
    ref8 = np.asarray(jax_int8.int8_matmul_reference(x, w8.numpy(), s8.numpy()))
    ref4 = np.asarray(jax_int4.int4_matmul_reference(x, p4.numpy(), s4.numpy()))
    for got, ref in ((got8, ref8), (got4, ref4)):
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
