"""The port's tiled matmul entry points (``kernels.ops.matmul`` and the
two-launch ``ops.lowrank_matmul_unfused``) on the CPU, where they run their
plain versions, against the reference's ``repro.kernels.matmul`` and
``lowrank_matmul_unfused`` run as tests/test_kernels.py runs them (the
Pallas kernel in interpret mode), on the same numpy inputs. The CUDA
kernel itself is held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11).

Tolerances: every product of two bf16 or f32 numbers is exact in f32 and
both packages sum in f32 in their own order, so an output differs by at
most 2 K eps (|A| |B|).max(). A bf16 output is rounded once on each side,
and two f32 sums that straddle a rounding boundary land one bf16 ulp apart:
up to 2^-7 of the value (8 significant bits), so 2^-7 of the output's
scale more. The two-launch pair is held one product
at a time at that bound: the port's h against the reference's product of
x and R^T, and the port's y against the reference's product of the port's
h and L^T. End to end, the two packages' h may also differ by one bf16
ulp, at most 2^-7 |h|, which L carries into y as at most
2^-7 (|h| |L^T|).max().
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank_matmul_unfused as rlowrank_unfused
from repro.kernels import matmul as rmatmul
from repro_torch.kernels import matmul_tiled as kmm
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32)


def _bound(a, b, bf16_out, scale):
    k = a.shape[1]
    tol = 2 * k * EPS32 * max((np.abs(a) @ np.abs(b)).max(), 1.0)
    return tol + (2.0 ** -7 * scale if bf16_out else 0.0)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 70, 50),
                                   (17, 33, 65), (1, 128, 1), (33, 257, 129),
                                   (5, 1, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_plain_path_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    got = ops.matmul(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    want = _np(rmatmul(_to_jax(_np(a), dtype), _to_jax(_np(b), dtype)))
    err = np.abs(_np(got) - want).max()
    assert err <= _bound(_np(a), _np(b), dtype == torch.bfloat16,
                         np.abs(want).max())


def test_matmul_reads_a_transposed_view_in_place():
    """B may be a strided view (R^T); the plain version and the kernel's
    wrapper take it as it is."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((9, 12)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((5, 12)).astype(np.float32))
    assert not r.T.is_contiguous()
    torch.testing.assert_close(ops.matmul(a, r.T), a @ r.T, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape,kdim,odim", [((4, 32, 96), 24, 48),
                                             ((3, 17, 70), 5, 33),
                                             ((1, 257, 130), 100, 7),
                                             ((5, 1, 9), 3, 513)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lowrank_unfused_plain_path_matches_reference(shape, kdim, odim,
                                                      dtype):
    rng = np.random.default_rng(sum(shape) + kdim)
    i = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    r = (rng.standard_normal((kdim, i)) * i ** -0.5).astype(np.float32)
    l_ = (rng.standard_normal((odim, kdim)) * kdim ** -0.5).astype(np.float32)
    tx, tr, tl = (torch.from_numpy(t).to(dtype) for t in (x, r, l_))
    got = ops.lowrank_matmul_unfused(tx, tr, tl)
    assert got.shape == (*shape[:-1], odim) and got.dtype == dtype
    want = _np(rlowrank_unfused(_to_jax(_np(tx), dtype),
                                _to_jax(_np(tr), dtype),
                                _to_jax(_np(tl), dtype)))
    bf16 = dtype == torch.bfloat16
    x2 = tx.reshape(-1, i)
    h = ops.matmul(x2, tr.T)
    assert torch.equal(got.reshape(-1, odim), ops.matmul(h, tl.T))
    # one product at a time, each against the reference's Pallas product
    want_h = _np(rmatmul(_to_jax(_np(x2), dtype), _to_jax(_np(tr).T, dtype)))
    assert np.abs(_np(h) - want_h).max() <= _bound(
        _np(x2), _np(tr).T, bf16, np.abs(want_h).max())
    want_y = _np(rmatmul(_to_jax(_np(h), dtype), _to_jax(_np(tl).T, dtype)))
    assert np.abs(_np(got).reshape(want_y.shape) - want_y).max() <= _bound(
        _np(h), _np(tl).T, bf16, np.abs(want_y).max())
    # end to end: h's rounding may differ by one ulp between the packages
    tol = _bound(_np(h), _np(tl).T, bf16, np.abs(want).max())
    if bf16:
        tol += 2.0 ** -7 * (np.abs(_np(h)) @ np.abs(_np(tl).T)).max()
    err = np.abs(_np(got).reshape(want.shape) - want).max()
    assert err <= tol


def test_unfused_rounds_h_to_the_input_dtype_between_launches():
    """bf16: h is written in x's dtype between the two launches, as the
    reference's ``matmul_tiled`` writes it; the fused path keeps it f32."""
    rng = np.random.default_rng(4)
    x, r, l_ = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .bfloat16() for s in ((64, 96), (24, 96), (48, 24)))
    got = ops.lowrank_matmul_unfused(x, r, l_)
    h = ref.matmul_ref(x, r.T)
    assert h.dtype == torch.bfloat16
    assert torch.equal(got, ref.matmul_ref(h, l_.T))
    assert not torch.equal(got, ref.lowrank_matmul_ref(x, r, l_))


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the dispatch takes the plain version; the kernel's own
    wrapper raises rather than fall back, before any build."""
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    before = ops.launch_counts()["matmul_tiled"]
    ops.matmul(a, b)
    assert ops.launch_counts()["matmul_tiled"] == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kmm.matmul_tiled(a, b)


# ---------------------------------------------------------------------------
# the route rule of kernel #9 (matmul_route)
# ---------------------------------------------------------------------------

def test_matmul_route_rule():
    """bf16 operands whose rows the 16-byte copies can read take the
    tensor-core route, B row-major or as a K-major view; f32, a K or N
    that is not a multiple of 8, B strides the copies cannot read, a row
    stride of A that is not a multiple of 8 and misaligned bases take the
    tiled kernel."""
    bf = torch.bfloat16
    a = torch.zeros(4, 896, dtype=bf)
    r = torch.zeros(256, 896, dtype=bf)
    w = torch.zeros(896, 256, dtype=bf)
    assert kmm.matmul_route(a, r.T) == "tensor_core"
    assert kmm.b_layout(r.T) == "k_major"
    assert kmm.matmul_route(a, w) == "tensor_core"
    assert kmm.b_layout(w) == "n_major"
    assert kmm.matmul_route(torch.zeros(2048, 256, dtype=bf),
                            torch.zeros(4864, 256, dtype=bf).T) == \
        "tensor_core"
    assert kmm.matmul_route(a.float(), r.T.float()) == "tiled"
    assert kmm.matmul_route(a[:, :893], w[:893]) == "tiled"
    assert kmm.matmul_route(a, w[:, :250]) == "tiled"
    assert kmm.matmul_route(a, w[:, ::2]) == "tiled"
    assert kmm.b_layout(w[:, ::2]) is None
    wide = torch.zeros(4, 900, dtype=bf)
    assert kmm.matmul_route(wide[:, :896], w) == "tiled"     # lda 900
    flat = torch.zeros(4 * 896 + 8, dtype=bf)
    assert kmm.matmul_route(flat[1:1 + 4 * 896].view(4, 896), w) == "tiled"
    assert kmm.matmul_route(flat[8:].view(4, 896), w) == "tensor_core"


def test_matmul_wrapper_raises_on_cpu_tensors_before_any_build(monkeypatch):
    """At either route's shapes the wrapper raises on a CPU tensor before a
    library is built or loaded, and counts nothing."""
    from repro_torch.kernels import _build

    def no_build(source):
        raise AssertionError(f"built {source}")

    monkeypatch.setattr(_build, "library", no_build)
    before = ops.launch_counts()["matmul_tiled"]
    for a, b in ((torch.zeros(4, 896).bfloat16(),
                  torch.zeros(256, 896).bfloat16().T),
                 (torch.zeros(33, 257), torch.zeros(257, 129))):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            kmm.matmul_tiled(a, b)
    assert ops.launch_counts()["matmul_tiled"] == before
