"""The CUDA kernels against their plain versions on the card. These tests
need an NVIDIA GPU and nvcc and skip without them; run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda.py`` (this file
imports no JAX, so it also runs where JAX is not installed)."""
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels import int8_matmul as ti8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 100, 300])
@pytest.mark.parametrize("K,N", [(64, 64), (300, 300), (1000, 2048),
                                 (5461, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_matches_plain(cuda, M, K, N, dtype):
    """2e-2 of max|plain| (the JAX package's kernel tolerance); small-M and
    tiled paths, ragged K, padded N, K splits."""
    g = torch.Generator(device=cuda).manual_seed(M * 7 + K)
    qt = quant.quantize_blockwise(torch.randn((K, N), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    LAUNCHES.clear()
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_matmul"] == 1
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 2e-2
    # padded columns dequantize to zero
    assert (got[:, N:] == 0).all()


def test_quantized_dense_launches_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    qt = quant.quantize_blockwise(torch.randn((300, 700), generator=g,
                                              device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((2, 5, 300), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    LAUNCHES.clear()
    got = ops.quantized_dense(x, qt, dtype=torch.bfloat16)
    assert got.shape == (2, 5, 700) and got.dtype == torch.bfloat16
    assert LAUNCHES["int8_matmul"] == 1 and LAUNCHES["deq_matmul"] == 0
    want = ref.deq_matmul(x.reshape(10, 300), qt.q, qt.scale, 256, 700)
    assert _rel(got.reshape(10, 700).float(), want) <= 2e-2


def test_wrapper_rejects_non_contiguous(cuda):
    qt = quant.quantize_blockwise(torch.randn((256, 256), device=cuda), 8,
                                  symmetric=True)
    x = torch.randn((256, 4), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        ti8.int8_matmul(x, qt.q, qt.scale)
