"""The port's CUDA kernels on the card (skipped where there is none).

Run on a GPU host with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
The flash kernel rounds P to bf16 before its P.V product while the plain
version keeps P in f32; both round the output to bf16: tolerance 2 bf16 ulps
relative plus atol 4e-3 on out, 1e-3 on lse. The backward kernels round P and
dS to bf16 and the gradients to bf16: 2 bf16 ulps relative plus 2 ulps of the
gradient's largest entry, against the plain backward on the kernel's own out
and lse; fully masked rows and all-false key columns exactly zero. The
dequant matmuls: see ``QUANT_SHAPES``.
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "b,t,s,n,kh,h",
    [(1, 692, 692, 8, 1, 256), (2, 130, 77, 8, 2, 256), (1, 65, 200, 4, 4, 128)],
)
def test_flash_kernel_matches_plain(cuda, b, t, s, n, kh, h):
    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    mask = torch.rand((b, t, s), generator=g, device=cuda) < 0.6
    mask[:, : t // 7] = False  # fully masked rows
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert out[:, : t // 7].abs().max().item() == 0.0


def test_flash_kernel_raises_on_unsupported_head_dim(cuda):
    from lap_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 256, 16, 72), dtype=torch.bfloat16, device=cuda)
    mask = torch.ones((1, 256, 256), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, mask)


# Forward kernel at the serving prefill and at ragged shapes: ragged T and S,
# GQA groups 1, 2 and 8, H = 128 and 256, batch 1 and 3.
FWD_CASES = [
    # name, (b, t, s, n, kh, h)
    ("prefill", (1, 692, 692, 8, 1, 256)),
    ("ragged_group2", (1, 203, 333, 8, 4, 256)),
    ("group8_h128", (1, 150, 1000, 8, 1, 128)),
    ("group1_h128", (1, 300, 141, 8, 8, 128)),
    ("ragged_b3", (3, 517, 700, 16, 2, 256)),
    ("gemma3_ar_prefill_group2", (1, 800, 864, 8, 4, 256)),
    # One rank's heads under tensor parallelism at tp = 2: LAP-3B's prefill
    # (4 query heads on its 1 KV head) and LAPGemma3-4B's (4 on 2).
    ("tp2_prefill_group4", (1, 692, 692, 4, 1, 256)),
    ("tp2_gemma3_prefill_group2", (1, 800, 800, 4, 2, 256)),
]


def _fwd_inputs(cuda, b, t, s, n, kh, h):
    """Random q, k, v and a mask with fully masked rows (the first t // 7)
    and rows whose later half of the keys is all masked."""
    g = torch.Generator(device=cuda).manual_seed(b * t + s)
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    mask = torch.rand((b, t, s), generator=g, device=cuda) < 0.6
    mask[:, : t // 7] = False
    mask[:, t // 7 : 2 * t // 7, s // 2 :] = False
    return q, k, v, mask


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_flash_forward_matches_plain_and_repeats_its_bits(cuda, case):
    """Against the plain version (the tolerances above); dead rows exactly
    zero with lse -2.3819763e38; one launch a call; two calls give the same
    bits."""
    from lap_tpu_torch.ops import flash_attention as fa

    _, shape = case
    q, k, v, mask = _fwd_inputs(cuda, *shape)
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    again, lse_again = fa.flash_attention_forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    t = shape[1]
    assert out[:, : t // 7].abs().max().item() == 0.0
    assert bool((lse[:, :, : t // 7] == fa.MASK_VALUE).all())
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


def test_flash_forward_batch2_prefill_with_two_valid_lengths(cuda):
    """The batched serving prefill of two prompts of different lengths (40
    and 95 of 180 prompt slots after two 256-token cameras): both rows'
    padding keys masked, the padded query rows fully masked; against the
    plain version at the forward's tolerances, the same bits twice."""
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.ops.masks import make_attn_mask

    t = 512 + 180
    valid = torch.tensor([[512 + 40], [512 + 95]], device=cuda)
    input_mask = torch.arange(t, device=cuda)[None, :] < valid
    mask = make_attn_mask(input_mask, torch.zeros_like(input_mask))
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, t, 8, 256), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((2, t, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((2, t, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    again, lse_again = fa.flash_attention_forward(q, k, v, mask)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


# The serving prefills of the serving stack's batched and bucketed calls:
# (prompt slots, valid prompt tokens of each row) after two 256-token cameras.
SERVING_PREFILLS = [
    ("batch2_78_108_of_180", 180, (78, 108)),
    ("token_bucket_92_of_128", 128, (92,)),
]


@pytest.mark.parametrize("case", SERVING_PREFILLS, ids=[c[0] for c in SERVING_PREFILLS])
def test_flash_forward_serving_stack_prefills(cuda, case):
    """The prefix-LM masks that the serving stack's batched call (two robots)
    and its --token_bucket 64 call give the forward: against the plain
    version at the forward's tolerances (atol 4e-3, rtol 1.6e-2; lse atol
    1e-3), the same bits twice."""
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.ops.masks import make_attn_mask

    _, slots, valid = case
    t = 512 + slots
    input_mask = torch.arange(t, device=cuda)[None, :] < torch.tensor([[512 + n] for n in valid], device=cuda)
    mask = make_attn_mask(input_mask, torch.zeros_like(input_mask))
    b = len(valid)
    g = torch.Generator(device=cuda).manual_seed(t + b)
    q = torch.randn((b, t, 8, 256), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, t, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, t, 1, 256), generator=g, device=cuda).to(torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    again, lse_again = fa.flash_attention_forward(q, k, v, mask)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


@pytest.mark.parametrize("h", [128, 256])
def test_forward_plan_matches_the_compiled_kernel(cuda, h):
    """The plan has the compiled kernel's shared memory and counts on no
    more resident blocks per SM than fit; the kernel spills nothing."""
    from lap_tpu_torch.ops import flash_attention as fa

    info = fa.forward_info(h)
    plan = fa.forward_plan(1, 692, 692, 8, 1, h)
    assert info["smem"] == plan["smem"] and info["blocks_per_sm"] >= plan["blocks_per_sm"], (info, plan)
    assert info["local_bytes"] == 0, info


BWD_CASES = [
    (2, 692, 708, 8, 1, 256),  # the LAP-3B training call: 16 all-false action columns
    (2, 816, 816, 8, 4, 256),  # the LAPGemma3-4B training call's shape: GQA group 2
    (2, 130, 77, 8, 2, 256),
    (1, 65, 200, 8, 2, 128),  # GQA group 4
    (2, 692, 708, 4, 1, 256),  # one rank's LAP-3B training call under tp = 2: group 4
]


def _bwd_inputs(cuda, b, t, s, n, kh, h):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, t, n, h), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, s, kh, h), generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn((b, t, n, h), generator=g, device=cuda).to(torch.bfloat16)
    mask = torch.rand((b, t, s), generator=g, device=cuda) < 0.6
    mask[:, : t // 7] = False  # fully masked rows
    mask[:, :, s - 16 :] = False  # all-false key columns
    return q, k, v, dout, mask


def _assert_grads_close(grads, refs):
    for got, ref in zip(grads, refs, strict=True):
        got, ref = got.float(), ref.float()
        bound = 1.6e-2 * ref.abs().max() + 1.6e-2 * ref.abs()
        assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("b,t,s,n,kh,h", BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, b, t, s, n, kh, h):
    from lap_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, mask = _bwd_inputs(cuda, b, t, s, n, kh, h)
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1, before[1] + 1)
    _assert_grads_close((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout))
    assert dq[:, : t // 7].abs().max().item() == 0.0
    assert dk[:, s - 16 :].abs().max().item() == 0.0 and dv[:, s - 16 :].abs().max().item() == 0.0


def test_flash_kernels_take_the_strides_of_the_training_call(cuda):
    """As ``gemma.Attention`` calls them under ``stop_action_to_vlm_grad``: q,
    the output gradient and the mask are the first 692 rows of the joint
    708-row tensors (batch strides of 708 rows), at the per-device batch 8."""
    from lap_tpu_torch.ops import flash_attention as fa

    b, t, s = 8, 692, 708
    q, k, v, dout, mask = _bwd_inputs(cuda, b, s, s, 8, 1, 256)
    q, dout, mask = q[:, :t], dout[:, :t], mask[:, :t]
    assert not q.is_contiguous() and not mask.is_contiguous()
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    _assert_grads_close((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout))
    assert dq[:, : s // 7].abs().max().item() == 0.0
    assert dk[:, s - 16 :].abs().max().item() == 0.0 and dv[:, s - 16 :].abs().max().item() == 0.0


def test_flash_attention_autograd_launches_the_backward_kernels(cuda):
    """Through ``torch.autograd``: a non-contiguous output gradient, and only
    the dQ kernel when keys and values are detached (the stop-gradient call)."""
    from lap_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, mask = _bwd_inputs(cuda, 1, 200, 216, 8, 1, 256)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, mask)
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out.transpose(1, 2).backward(dout.transpose(1, 2))  # the gradient arrives transposed
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        o, lse = fa.flash_attention_forward(q, k, v, mask)
        refs = fa.flash_attention_backward_plain(q, k, v, mask, o, lse, dout)
    _assert_grads_close((q.grad, k.grad, v.grad), refs)

    q2 = q.detach().clone().requires_grad_()
    fa.flash_attention(q2, k.detach(), v.detach(), mask).backward(dout)
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(q2.grad, q.grad, atol=0, rtol=0)


def test_flash_backward_raises_on_a_cuda_tensor_it_cannot_take(cuda):
    from lap_tpu_torch.ops import flash_attention as fa

    q = torch.zeros((1, 256, 16, 72), dtype=torch.bfloat16, device=cuda)
    mask = torch.ones((1, 256, 256), dtype=torch.bool, device=cuda)
    lse = torch.zeros((1, 16, 256), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, q, q, mask, q, lse, q)


@pytest.mark.parametrize("n,kh", [(8, 1), (4, 2)])
def test_flash_backward_grouped_ragged_edges(cuda, n, kh):
    """GQA groups 8 and 2 at H = 256 (the group-sum pass) with fully masked
    rows, all-false key columns, and T and S that are multiples of no tile
    (16, 32, 64); one launch of each kernel and of the pass."""
    from lap_tpu_torch.ops import flash_attention as fa

    b, t, s, h = 2, 203, 141, 256
    q, k, v, dout, mask = _bwd_inputs(cuda, b, t, s, n, kh, h)
    mask[:, :, 37:59] = False  # all-false key columns inside a tile as well
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    counters = ("launches_bwd_dq", "launches_bwd_dkv", "launches_bwd_delta", "launches_bwd_group_sum")
    before = [getattr(fa, c) for c in counters]
    dq, dk, dv = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    assert [getattr(fa, c) - x for c, x in zip(counters, before)] == [1, 1, 1, 1]
    _assert_grads_close((dq, dk, dv), fa.flash_attention_backward_plain(q, k, v, mask, out, lse, dout))
    assert dq[:, : t // 7].abs().max().item() == 0.0
    for cols in (slice(37, 59), slice(s - 16, s)):
        assert dk[:, cols].abs().max().item() == 0.0 and dv[:, cols].abs().max().item() == 0.0


@pytest.mark.parametrize("case", ["training_step", "gqa_group4_h128", "tp2_training_step"])
def test_flash_backward_gives_the_same_bits_twice(cuda, case):
    """No atomics: two calls on the same inputs give the same bits, at the
    training call's shape and strides (group 8; group 4 for one rank's heads
    under tp = 2) and at group 4, H = 128."""
    from lap_tpu_torch.ops import flash_attention as fa

    if case in ("training_step", "tp2_training_step"):
        b, t, s = 8, 692, 708
        q, k, v, dout, mask = _bwd_inputs(cuda, b, s, s, 8 if case == "training_step" else 4, 1, 256)
        q, dout, mask = q[:, :t], dout[:, :t], mask[:, :t]
    else:
        q, k, v, dout, mask = _bwd_inputs(cuda, 2, 300, 270, 8, 2, 128)
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    first = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
    second = fa.flash_attention_backward(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second, strict=True):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,t,n,h,strided", [(8, 692, 8, 256, True), (2, 77, 4, 128, False)])
def test_flash_delta_kernel_matches_plain(cuda, b, t, n, h, strided):
    """delta = sum_h dO * O in f32, one launch: the kernel and the plain
    version sum the same products in other orders, each within (H - 1) f32
    ulps of the sum of |dO * O|."""
    from lap_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(3)
    rows = t + 16 if strided else t  # out and dO as slices of a longer tensor
    out = torch.randn((b, rows, n, h), generator=g, device=cuda).to(torch.bfloat16)[:, :t]
    dout = torch.randn((b, rows, n, h), generator=g, device=cuda).to(torch.bfloat16)[:, :t]
    before = fa.launches_bwd_delta
    delta = fa.flash_attention_delta(out, dout)
    torch.cuda.synchronize()
    assert fa.launches_bwd_delta == before + 1
    ref = fa.flash_attention_delta_plain(out, dout)
    bound = 2 * (h - 1) * 2.0**-24 * (dout.float() * out.float()).abs().sum(-1).transpose(1, 2)
    assert delta.shape == (b, n, t) and bool(((delta - ref).abs() <= bound).all())


@pytest.mark.parametrize("h", [128, 256])
def test_backward_plan_matches_the_compiled_kernels(cuda, h):
    """The wrapper's launch plan has the compiled kernels' shared memory, and
    the occupancy query keeps at least two blocks of each on an SM."""
    from lap_tpu_torch.ops import flash_attention as fa

    plan = fa.backward_plan(8, 692, 708, 8, 1, h)
    info = fa.backward_info(h)
    for name in ("dq", "dkv"):
        assert info[name]["smem"] == plan[name + "_smem"]
        assert info[name]["blocks_per_sm"] >= 2, info


def test_lap_training_pass_goes_through_the_kernels(cuda):
    """A narrow two-expert model at head dim 128 and 200 prefix tokens: the
    ``auto`` rule takes the flash kernels forward and backward on the card."""
    from lap_tpu_torch.models import gemma
    from lap_tpu_torch.ops import flash_attention as fa

    cfg = gemma.Config(width=128, depth=2, mlp_dim=256, num_heads=2, num_kv_heads=1, head_dim=128)
    model = gemma.Module([cfg, cfg], use_adarms=[False, True], stop_action_to_vlm_grad=True,
                         vocab_size=512, device=cuda, dtype=torch.float32)
    from lap_tpu_torch.models.init import random_init_

    random_init_(model, 0)
    g = torch.Generator(device=cuda).manual_seed(2)
    prefix = torch.randn((2, 200, 128), generator=g, device=cuda)
    suffix = torch.randn((2, 8, 128), generator=g, device=cuda)
    cond = torch.randn((2, 128), generator=g, device=cuda)
    mask = torch.ones((2, 208, 208), dtype=torch.bool, device=cuda)
    mask[:, :200, 200:] = False
    pos = torch.arange(208, device=cuda).expand(2, 208)
    counts = {}
    for impl in ("auto", "xla"):
        model.set_attn_impl(impl)
        model.zero_grad(set_to_none=True)
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        (o0, o1), _ = model([prefix, suffix], pos, mask, [None, cond], want_cache=False)
        (o0.float().square().mean() + o1.float().square().mean()).backward()
        torch.cuda.synchronize()
        counts[impl] = tuple(a - b for a, b in zip((fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv), before))
        counts[impl + "_grad"] = model.layers[0].attn.kv_einsum[0].w.grad.clone()
    assert counts["auto"] == (4, 2, 2)  # 2 layers, forward run again by the rematerialisation
    assert counts["xla"] == (0, 0, 0)
    rel = (counts["auto_grad"] - counts["xla_grad"]).norm() / counts["xla_grad"].norm()
    assert rel.item() < 3e-2


# Dequant matmuls: (K, N) of every quantized weight of LAP-3B serving (q and
# attn_vec; MLP gate/up and down; vocab head; action-expert MLP). The kernel
# rounds its f32 sum to bf16 once; the plain version is taken in f32: one
# bf16 rounding plus the summation order, |kernel - plain| <= 8e-3 |plain| +
# 1e-4 max|plain|.
QUANT_SHAPES = [(2048, 2048), (2048, 32768), (16384, 2048), (2048, 257152), (1024, 8192), (4096, 1024),
                # LAPGemma3-4B: gemma3_4b's q/kv, attn_vec, gating and linear, the 262,144-row
                # vocab head, and the gemma3_300m expert's gating (K = 768: int4 group 128).
                (2560, 2048), (2048, 2560), (2560, 20480), (10240, 2560), (2560, 262144), (768, 6144)]


def _assert_dequant_close(got, ref):
    ref = ref.float()
    bound = 8e-3 * ref.abs() + 1e-4 * ref.abs().max()
    assert bool(((got.float() - ref).abs() <= bound).all()), (got.float() - ref).abs().max().item()


@pytest.mark.parametrize("k,n", QUANT_SHAPES)
@pytest.mark.parametrize("m", [1, 16, 100, 128])
def test_dequant_kernels_match_plain(cuda, m, k, n):
    from lap_tpu_torch.ops import int4_matmul as i4
    from lap_tpu_torch.ops import int8_matmul as i8

    from lap_tpu_torch.models.lora import _int4_group

    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    w = torch.randn((k, n), generator=g, device=cuda).to(torch.bfloat16) * 0.02
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)

    def quantize_int4(w):  # the group the serving path takes for this K
        return i4.quantize_int4(w, group_size=_int4_group(k))

    for mod, fn, plain, quantize in ((i8, i8.int8_matmul, i8.int8_matmul_plain, i8.quantize_int8),
                                     (i4, i4.int4_matmul, i4.int4_matmul_plain, quantize_int4)):
        wq, s = quantize(w)
        before = mod.launches
        got = fn(x, wq, s)
        torch.cuda.synchronize()
        assert mod.launches == before + 1 and got.dtype == torch.bfloat16 and got.shape == (m, n)
        _assert_dequant_close(got, plain(x.float(), wq, s))
        del wq, s


def test_dequant_kernels_are_deterministic_and_raise_on_what_they_cannot_take(cuda):
    """Two calls give the same bits at one split (the vocab head: bf16 written
    directly) and at many (MLP down: the last block of a tile adds the
    splits in order), for 1 to 128 rows; interleaved int8 and int4 calls of
    different shapes leave the split-K arrival counters at zero."""
    from lap_tpu_torch.ops import int4_matmul as i4
    from lap_tpu_torch.ops import int8_matmul as i8

    g = torch.Generator(device=cuda).manual_seed(3)
    for k, n, one_split in ((2048, 257152, True), (16384, 2048, False)):
        w = torch.randn((k, n), generator=g, device=cuda)
        w8, w4 = i8.quantize_int8(w), i4.quantize_int4(w)
        del w
        for m in (1, 16, 100, 128):
            x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
            for kind, fn, weights in (("int8", i8.int8_matmul, w8), ("int4", i4.int4_matmul, w4)):
                plan = i8.launch_plan(kind, m, k, n, 256 if kind == "int4" else None,
                                      torch.cuda.get_device_properties(cuda).multi_processor_count)
                assert (plan["splits"] == 1) == one_split, plan
                assert torch.equal(fn(x, *weights), fn(x, *weights)), (kind, k, n, m)
        del w8, w4
    w = torch.randn((2048, 2048), generator=g, device=cuda)
    x = torch.randn((16, 2048), generator=g, device=cuda).to(torch.bfloat16)
    w8, w4 = i8.quantize_int8(w), i4.quantize_int4(w)
    wd = torch.randn((4096, 1024), generator=g, device=cuda)
    wd8, wd4 = i8.quantize_int8(wd), i4.quantize_int4(wd)
    xd = torch.randn((100, 4096), generator=g, device=cuda).to(torch.bfloat16)
    for _ in range(3):
        i8.int8_matmul(x, *w8)
        i4.int4_matmul(xd, *wd4)
        i4.int4_matmul(x[:1], *w4)
        i8.int8_matmul(xd[:7], *wd8)
    torch.cuda.synchronize()
    assert int(i8.splitk_counters(cuda).abs().sum()) == 0
    # ``cuda`` and ``cuda:<index>`` name the same counters: a count left
    # behind on one is seen through the other.
    assert i8.splitk_counters(cuda) is i8.splitk_counters(torch.device("cuda", torch.cuda.current_device()))
    assert torch.equal(i8.int8_matmul(x, *w8), i8.int8_matmul(x, *w8))  # split-K sums in a fixed order
    assert torch.equal(i4.int4_matmul(x, *w4), i4.int4_matmul(x, *w4))
    with pytest.raises(ValueError, match="bfloat16"):
        i8.int8_matmul(x.float(), *w8)  # f32 activations: raise, never the plain version
    with pytest.raises(ValueError, match="bfloat16"):
        i4.int4_matmul(x.float(), *w4)
    w_odd = torch.randn((160, 256), generator=g, device=cuda)
    with pytest.raises(ValueError):
        i8.int8_matmul(x[:, :160], *i8.quantize_int8(w_odd))  # K % 64 != 0
    with pytest.raises(ValueError):
        i4.int4_matmul(x[:, :64], *i4.quantize_int4(w_odd[:64], group_size=32))


@pytest.mark.parametrize("rows_per_tile", [8, 16])
def test_dequant_plan_matches_the_compiled_kernels(cuda, rows_per_tile):
    """The wrapper's launch plan has the compiled kernels' shared memory and
    counts on no more resident blocks per SM than fit, and the kernels spill
    nothing."""
    from lap_tpu_torch.ops import int4_matmul as i4
    from lap_tpu_torch.ops import int8_matmul as i8

    for kind, module in (("int8", i8), ("int4", i4)):
        info = module.info(rows_per_tile)
        plan = i8.launch_plan(kind, rows_per_tile, 2048, 2048, 256 if kind == "int4" else None)
        assert info["smem"] == plan["smem"] and info["blocks_per_sm"] >= plan["blocks_per_sm"], (info, plan)
        assert info["local_bytes"] == 0, info


def test_quantized_feed_forward_goes_through_the_kernel(cuda):
    """The gemma_300m expert MLP quantized to int4: 16 rows take the kernels
    (2 launches) and agree with the plain versions on the CPU to 1e-2
    relative L2 (a bf16 rounding of the gates lands on the other side now and
    then); 208 rows take the exact bf16 product, bit for bit."""
    import copy

    import torch.nn.functional as F

    from lap_tpu_torch.models import lora
    from lap_tpu_torch.ops import int4_matmul as i4

    g = torch.Generator(device=cuda).manual_seed(4)
    ff = lora.FeedForward(1024, 4096, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        ff.random_init_(g)
    ff.quantize_("int4")
    on_cpu = copy.deepcopy(ff).cpu()
    x = torch.randn((1, 16, 1024), generator=g, device=cuda).to(torch.bfloat16)
    rows = x.expand(13, 16, 1024)
    with torch.no_grad():
        before = i4.launches
        got = ff(x)
        assert i4.launches == before + 2
        ref = on_cpu(x.cpu())
        exact = ff(rows)
        assert i4.launches == before + 2
        w = ff.gating_einsum
        manual = (F.gelu(rows @ w[0], approximate="tanh") * (rows @ w[1])) @ ff.linear
    assert torch.equal(exact, manual)
    rel = ((got.cpu().float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel < 1e-2


def test_flash_forward_at_the_gemma3_prefill_masks(cuda):
    """LAPGemma3-4B's prefill masks (GQA group 2): a prompt of 577 valid
    tokens in 800 slots with two 256-token image blocks, left-aligned (flow)
    and right-aligned with 64 decode slots (AR), on a local layer (sliding
    window 1024 over RoPE positions against cache slots, the image blocks
    OR'd in) and a global one. The AR local mask has valid rows with no key:
    exactly zero with lse -2.3819763e38."""
    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.models.lap_gemma3 import left_to_right_align_with_image_mask
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.ops.masks import make_attn_mask

    t, valid = 800, 577
    image = torch.zeros((1, t), dtype=torch.bool, device=cuda)
    image[:, 15:271] = True
    image[:, 274:530] = True
    input_mask = torch.arange(t, device=cuda)[None] < valid
    attn = make_attn_mask(input_mask, torch.zeros_like(input_mask))
    _, aligned, attn_al, image_al = left_to_right_align_with_image_mask(
        torch.zeros((1, t, 1), device=cuda), input_mask, attn, image)
    attn_al = torch.nn.functional.pad(attn_al, (0, 64))
    masks = []
    for is_global in (False, True):
        masks.append(gemma3.effective_mask(attn, torch.cumsum(input_mask, 1) - 1, t, is_global=is_global,
                                           window=1024, image_mask=image))
        masks.append(gemma3.effective_mask(attn_al, torch.cumsum(aligned, 1) - 1, t + 64, is_global=is_global,
                                           window=1024, image_mask=image_al))
    assert int((~masks[1].any(-1) & aligned).sum()) > 0  # dead valid rows on the AR local layer
    g = torch.Generator(device=cuda).manual_seed(8)
    for mask in masks:
        s = mask.shape[-1]
        q = torch.randn((1, t, 8, 256), generator=g, device=cuda).to(torch.bfloat16)
        k, v = (torch.randn((1, s, 4, 256), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_forward(q, k, v, mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
        dead = ~mask.any(-1)
        if dead.any():
            assert out.float()[dead].abs().max().item() == 0.0
            assert bool((lse.transpose(1, 2)[dead] == fa.MASK_VALUE).all())


def test_quantized_gemma3_feed_forward_takes_group_128(cuda):
    """The gemma3_300m expert's MLP quantized to int4: its gating (K = 768)
    takes group 128 and the kernel at 16 rows (one launch; the linear stays
    bf16 under the size threshold), within 1e-2 relative L2 of the plain
    version on the CPU."""
    import copy

    from lap_tpu_torch.models import gemma3
    from lap_tpu_torch.ops import int4_matmul as i4

    g = torch.Generator(device=cuda).manual_seed(5)
    ff = gemma3.FeedForward(768, 3072, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        ff.random_init_(g)
    ff.quantize_("int4")
    packed, scales = ff.quantized("gating_")
    assert packed.shape == (384, 6144) and scales.shape == (6, 6144)  # 768 / 128 groups
    assert ff.quantized("linear_") is None
    on_cpu = copy.deepcopy(ff).cpu()
    x = torch.randn((1, 16, 768), generator=g, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        before = i4.launches
        got = ff(x)
        assert i4.launches == before + 1
        ref = on_cpu(x.cpu())
    rel = ((got.cpu().float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel < 1e-2


def _variant_case(cuda, name):
    import chip_smoke as cs

    if name == "lora_training_step":
        return cs.lora_training_mask(cuda)
    return {n: m for n, _, m in cs.variant_kernel_cases(cuda)}[name]


@pytest.mark.parametrize("name", ["fast_flow_prefill", "vla0_ar_prefill", "lora_training_step"])
def test_flash_forward_at_the_variant_cases(cuda, name):
    """The three flash-forward cases of chip_smoke.py phase 15, built as
    phase 2 builds them: the FAST flow prefix (B=1, T=S=732), the VLM-only
    AR prefill right-aligned with 64 decode slots (B=1, T=902, S=966) and the
    LoRA training step's prefix call on the fake loader's first batch (B=8,
    the first 692 rows of the joint 708-row mask, its strides); against the
    plain version at the forward's tolerances, the same bits twice."""
    from lap_tpu_torch.ops import flash_attention as fa

    mask = _variant_case(cuda, name)
    b, t, s = mask.shape
    g = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn((b, t, 8, 256), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, s, 1, 256), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, mask)
    again, lse_again = fa.flash_attention_forward(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=4e-3, rtol=1.6e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


def test_lora_adapted_quantized_decode_goes_through_the_kernel(cuda):
    """A LoRA VLM (gemma_300m_lora) beside a plain gemma_300m expert, int8:
    the adapted weights keep no quantized copy, the vocab head and the
    expert's MLPs do. An AR step launches the dequant kernel once (the head),
    and its logits equal those of the same step with the plain version in
    the kernel's place to the dequant bound (8e-3 |ref| + 1e-4 max |ref|,
    as ``QUANT_SHAPES``); a flow suffix step launches it twice a layer (the
    expert's gating and linear)."""
    from lap_tpu_torch.models.lap_model import LAPConfig
    from lap_tpu_torch.ops import int8_matmul as i8

    config = LAPConfig(paligemma_variant="gemma_300m_lora", action_expert_variant="gemma_300m",
                       siglip_variant="dummy", action_horizon=4, max_token_len=32, enable_action_training=True)
    model = config.create_module(device=cuda, init_seed=0)
    with torch.no_grad():  # adapters away from their zero init, so that they count
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=torch.Generator(device=cuda).manual_seed(1))
    model.quantize_("int8")
    quantized = {n.rsplit(".", 1)[0] for n, _ in model.named_buffers() if n.endswith("scale")}
    assert "llm.embedder" in quantized and "llm.layers.0.mlp.1" in quantized
    assert not [n for n in quantized if n.startswith("llm.layers.") and n.endswith(".0")]  # the adapted VLM
    obs = config.fake_obs(1, device=cuda)
    obs = obs.replace(tokenized_prompt_mask=torch.arange(32, device=cuda)[None] < 20)
    token = torch.full((1, 1), 7, dtype=torch.int32, device=cuda)
    state = model.ar_prefill(obs, 2)
    before = i8.launches
    got = model.ar_step(state, token).float()
    torch.cuda.synchronize()
    assert i8.launches == before + 1
    kernel = i8.int8_matmul
    i8.int8_matmul = i8.int8_matmul_plain
    try:
        ref = model.ar_step(model.ar_prefill(obs, 2), token).float()
    finally:
        i8.int8_matmul = kernel
    assert bool(((got - ref).abs() <= 8e-3 * ref.abs() + 1e-4 * ref.abs().max()).all())
    depth = len(model.llm.layers)
    before = i8.launches
    model.sample_actions(obs, num_steps=1)
    torch.cuda.synchronize()
    assert i8.launches == before + 2 * depth
