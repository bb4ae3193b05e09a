"""The port's CUDA kernels on the card (skipped where there is none).

Run on a GPU host with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
The flash kernel rounds P to bf16 before its P.V product while the plain
version keeps P in f32; both round the output to bf16: tolerance 2 bf16 ulps
relative plus atol 4e-3 on out, 1e-3 on lse.
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
