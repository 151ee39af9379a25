"""WKV6: the port (repro_torch.kernels.rwkv6) against the JAX reference
(repro.kernels.rwkv6), same NumPy inputs made from a seed.

On the CPU the port's plain versions (``wkv6_scan``, ``wkv6_chunked``) are
held against the reference's scan, its chunked form and its Pallas kernel
in interpret mode, over the grid of the reference's own tests
(tests/test_kernels.py), at its bar: atol 2e-4, rtol 2e-3. Final states and
gradients are held tighter. The CUDA kernel is held against the plain
versions on the card by the `cuda`-marked tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.kernels.rwkv6 import ref as tref
from _jax_oracle import oracle_on_cpu  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3          # tests/test_kernels.py, wkv6 cases


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(scope="module")
def jref():
    """(jax, jnp, the reference's ops and ref modules); skips without JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rwkv6 import ops as jops
    from repro.kernels.rwkv6 import ref as jrefm
    return jax, jnp, jops, jrefm


def _inputs(seed, B, S, H, K, V):
    """r, k, v, log_w, u as the reference's tests draw them, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, V)
    lw = -np.exp(np.clip(f(B, S, H, K), -8, 1.6)).astype(np.float32)
    u = (f(H, K) * 0.3).astype(np.float32)
    return r, k, v, lw, u


def _gap(what, got, want, bar):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    print(f"parity-gap {what}: {gap:.2e} (bar {bar:.0e})")
    assert gap <= bar, (what, gap, bar)


@pytest.mark.parametrize("S", [32, 64, 80])
@pytest.mark.parametrize("K,V", [(16, 16), (16, 24), (64, 64)])
def test_plain_matches_reference_scan_chunked_and_interpret(jref, S, K, V):
    _, jnp, jops, jrefm = jref
    arrays = _inputs(S + K + V, 2, S, 2, K, V)
    ja = [jnp.asarray(a) for a in arrays]
    refs = {"scan": jrefm.wkv6_scan(*ja),
            "chunked": jrefm.wkv6_chunked(*ja, chunk=16),
            "interpret": jops.wkv6(*ja, backend="interpret")}
    ta = [torch.tensor(a) for a in arrays]
    ports = {"scan": tref.wkv6_scan(*ta),
             "chunked": tref.wkv6_chunked(*ta, chunk=16)}
    for pname, out in ports.items():
        assert out.dtype == torch.float32 and out.shape == (2, S, 2, V)
        for rname, want in refs.items():
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=RTOL)
            _gap(f"wkv6 port {pname} vs reference {rname} S={S} K={K} V={V}",
                 out.numpy(), want, RTOL)


@pytest.mark.parametrize("S", [48, 40])        # whole chunks, and ragged
def test_final_state_matches_reference_chunked(jref, S):
    _, jnp, _, jrefm = jref
    arrays = _inputs(11, 1, S, 2, 16, 16)
    o_j, st_j = jrefm.wkv6_chunked(*(jnp.asarray(a) for a in arrays),
                                   chunk=16, return_state=True)
    o_t, st_t = tref.wkv6_chunked(*(torch.tensor(a) for a in arrays),
                                  chunk=16, return_state=True)
    assert st_t.shape == (1, 2, 16, 16)
    _gap(f"wkv6 final state S={S}", st_t.numpy(), st_j, 1e-5)
    _gap(f"wkv6 chunked output S={S}", o_t.numpy(), o_j, 1e-5)


def test_chunked_gradients_match_jax_grad(jref):
    jax, jnp, _, jrefm = jref
    arrays = _inputs(12, 2, 40, 2, 16, 24)
    cot = np.random.default_rng(13).standard_normal((2, 40, 2, 24)).astype(
        np.float32)

    def jloss(*a):
        return jnp.sum(jrefm.wkv6_chunked(*a, chunk=16) * cot)

    gj = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in arrays))
    ta = [torch.tensor(a, requires_grad=True) for a in arrays]
    (tref.wkv6_chunked(*ta, chunk=16) * torch.tensor(cot)).sum().backward()
    for name, t, g in zip(("r", "k", "v", "log_w", "u"), ta, gj):
        _gap(f"wkv6 chunked grad {name}", t.grad.numpy(), g, 1e-4)


def test_recurrence_closed_form_matches_loop():
    """The closed form of the chunk recurrence against the loop it stands
    for, at a strong decay over many chunks (large |cumsum log a|)."""
    from repro_torch.models.layers import _prev_states
    rng = np.random.default_rng(14)
    a = torch.tensor(np.exp(-rng.uniform(0.0, 40.0, (3, 64, 8))))
    b = torch.tensor(rng.standard_normal((3, 64, 8, 5)))
    prev, final = _prev_states(a, b)
    s = torch.zeros((3, 8, 5), dtype=torch.float64)
    for i in range(64):
        torch.testing.assert_close(prev[:, i], s, rtol=1e-6, atol=1e-12)
        s = a[:, i, :, None] * s + b[:, i]
    torch.testing.assert_close(final, s, rtol=1e-6, atol=1e-12)


def test_dispatch_and_validation():
    r, k, v, lw, u = (torch.tensor(a) for a in _inputs(15, 1, 32, 2, 16, 16))
    before = wkv_kernel.launches
    assert torch.equal(tops.wkv6(r, k, v, lw, u),
                       tref.wkv6_chunked(r, k, v, lw, u))
    torch.testing.assert_close(tops.wkv6(r, k, v, lw, u, backend="scan"),
                               tref.wkv6_scan(r, k, v, lw, u))
    assert wkv_kernel.launches == before       # CPU: the plain versions
    with pytest.raises(ValueError, match="backend"):
        tops.wkv6(r, k, v, lw, u, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.wkv6_cuda(r, k, v, lw, u)
    # a ragged S takes the kernel route no more than wkv6_pallas does; a
    # meta tensor is not a CPU tensor, so it is routed to the kernel
    meta = [torch.tensor(a).to("meta") for a in _inputs(15, 1, 40, 2, 16, 16)]
    with pytest.raises(ValueError, match="chunk"):
        tops.wkv6(*meta)


def test_function_backward_is_the_chunked_gradient(monkeypatch):
    """WKV6Function's backward, run on the CPU with the scan standing in
    for the kernel's forward: the gradients of the plain chunked form."""
    monkeypatch.setattr(tops, "wkv6_cuda", tref.wkv6_scan)
    arrays = _inputs(16, 2, 48, 2, 16, 24)
    cot = torch.tensor(np.random.default_rng(17).standard_normal(
        (2, 48, 2, 24)).astype(np.float32))
    ta = [torch.tensor(a, requires_grad=True) for a in arrays]
    tb = [torch.tensor(a, requires_grad=True) for a in arrays]
    (tops.WKV6Function.apply(*ta, 16) * cot).sum().backward()
    (tref.wkv6_chunked(*tb, chunk=16) * cot).sum().backward()
    for a, b in zip(ta, tb):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV6 kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,V", [
    (2, 64, 3, 16, 24), (1, 80, 2, 64, 64), (2, 256, 4, 32, 32),
    (1, 48, 1, 24, 16), (1, 1024, 2, 64, 64),
])
def test_kernel_matches_plain_on_cuda(cuda_device, B, S, H, K, V):
    ta = [torch.tensor(a, device=cuda_device)
          for a in _inputs(18, B, S, H, K, V)]
    before = wkv_kernel.launches
    out = tops.wkv6(*ta)
    torch.cuda.synchronize()
    assert wkv_kernel.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, S, H, V)
    for backend in ("scan", "chunked"):
        torch.testing.assert_close(out, tops.wkv6(*ta, backend=backend),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_reads_strided_model_layout_on_cuda(cuda_device):
    """r/k/v/log_w as views with a non-contiguous head stride, bf16 r."""
    big = [torch.tensor(a, device=cuda_device)
           for a in _inputs(19, 2, 64, 4, 32, 32)]
    ta = [t[:, :, ::2] if t.dim() == 4 else t[::2] for t in big]
    ta[0] = ta[0].bfloat16()
    out = tops.wkv6(*ta)
    torch.testing.assert_close(out, tops.wkv6(*ta, backend="scan"),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_function_gradients_on_cuda(cuda_device):
    arrays = _inputs(20, 2, 128, 3, 64, 64)
    cot = torch.tensor(np.random.default_rng(21).standard_normal(
        (2, 128, 3, 64)).astype(np.float32), device=cuda_device)
    ta = [torch.tensor(a, device=cuda_device, requires_grad=True)
          for a in arrays]
    tb = [torch.tensor(a, device=cuda_device, requires_grad=True)
          for a in arrays]
    (tops.wkv6(*ta) * cot).sum().backward()
    (tref.wkv6_chunked(*tb) * cot).sum().backward()
    for a, b in zip(ta, tb):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ragged_seq_raises_on_cuda(cuda_device):
    ta = [torch.tensor(a, device=cuda_device)
          for a in _inputs(22, 1, 40, 2, 16, 16)]
    with pytest.raises(ValueError, match="chunk"):
        tops.wkv6(*ta)
    assert tops.wkv6(*ta, backend="chunked").shape == (1, 40, 2, 16)
    with pytest.raises(ValueError, match="up to 64"):
        wkv_kernel.wkv6_cuda(*(torch.tensor(a, device=cuda_device)
                               for a in _inputs(23, 1, 16, 1, 80, 16)))
