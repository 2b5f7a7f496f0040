"""The CUDA kernel against its plain version, on the card.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only the port's stack:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lowrank, ops, ref

EPS32 = float(np.finfo(np.float32).eps)

# (lead dims, I, K, O): ragged M/I/K/O, leading dims, odd I (unaligned
# bf16 pairs), and the four site shapes of qwen2-0.5b at decode and
# prefill row counts
SHAPES = [((4, 32), 96, 24, 48), ((3, 17), 70, 5, 33), ((1, 257), 130, 100, 7),
          ((5, 1), 9, 3, 513), ((2, 3, 7), 64, 16, 40), ((6,), 37, 300, 19),
          ((4,), 896, 256, 896), ((4,), 896, 128, 128),
          ((4,), 896, 256, 4864), ((4,), 4864, 256, 896),
          ((300,), 896, 256, 4864), ((97,), 4864, 256, 896)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(run on the card, see README 'PyTorch/CUDA port')")
    return torch.device("cuda")


def _inputs(lead, i, k, o, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*lead, i, generator=g)
    r = torch.randn(k, i, generator=g) * i ** -0.5
    l_ = torch.randn(o, k, generator=g) * k ** -0.5
    return tuple(t.to(device, dtype) for t in (x, r, l_))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,i,k,o", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, lead, i, k, o, dtype):
    """Tolerance: f32 sums of I then K terms in another order, bounded by
    2 (I + K) eps |y|; bf16 adds one rounding of the output (up to 2^-7
    relative)."""
    x, r, l_ = _inputs(lead, i, k, o, cuda, dtype)
    before = ops.LAUNCHES["lowrank_fwd"]
    got = ops.lowrank_matmul(x, r, l_)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lowrank_fwd"] == before + 1
    assert got.shape == (*lead, o) and got.dtype == dtype
    want = ref.lowrank_matmul_ref(x, r, l_)
    scale = want.float().abs().max().item()
    tol = 2 * (i + k) * EPS32 * max(scale, 1.0)
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    x, r, l_ = _inputs((256,), 896, 256, 4864, cuda, torch.bfloat16)
    a = ops.lowrank_matmul(x, r, l_)
    b = ops.lowrank_matmul(x, r, l_)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, r, l_ = _inputs((8,), 32, 8, 16, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        lowrank.lowrank_fused(x.T.contiguous().T, r, l_)
    with pytest.raises(ValueError, match="dtypes differ"):
        lowrank.lowrank_fused(x, r.to(torch.bfloat16), l_)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lowrank.lowrank_fused(x, r.cpu(), l_)
    with pytest.raises(ValueError, match="not supported"):
        lowrank.lowrank_fused(*(t.half() for t in (x, r, l_)))
    with pytest.raises(ValueError, match="do not chain"):
        lowrank.lowrank_fused(x, r[:, :16].contiguous(), l_)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("ks", [8, 16, 32, 40, 128])
def test_smem_formula_matches_the_source(cuda, bm, ks):
    """The wrapper checks the per-CTA shared memory against the card's
    limit with its own copy of the source's formula; the two agree."""
    lib = lowrank._lib()
    assert lib.lowrank_fwd_smem_bytes(bm, ks) == lowrank.smem_bytes(bm, ks)
