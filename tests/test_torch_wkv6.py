"""WKV6: the port (repro_torch.kernels.rwkv6) against the JAX reference
(repro.kernels.rwkv6), same NumPy inputs made from a seed.

On the CPU the port's plain versions (``wkv6_scan``, ``wkv6_chunked``) are
held against the reference's scan, its chunked form and its Pallas kernel
in interpret mode, over the grid of the reference's own tests
(tests/test_kernels.py), at its bar: atol 2e-4, rtol 2e-3. Final states and
gradients are held tighter; the closed-form gradient ``wkv6_grad`` (the
plain version of the gradient kernel) is held against ``jax.grad`` of the
reference's chunked form and scan at 1e-5. The CUDA kernels are held
against the plain versions on the card by the `cuda`-marked tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.kernels.rwkv6 import ref as tref
from _jax_oracle import oracle_on_cpu  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3          # tests/test_kernels.py, wkv6 cases
GRAD_TOL = 1e-5                  # relative Frobenius, per gradient
GRADS = ("r", "k", "v", "log_w", "u")


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


@pytest.mark.parametrize("S,K,V", [
    (S, K, V) for S in (32, 64, 80) for K, V in ((16, 16), (16, 24), (64, 64))
] + [(1024, 16, 16), (1024, 64, 64)])
def test_closed_form_gradient_matches_jax_grad(jref, S, K, V):
    """ref.wkv6_grad against jax.grad of the reference's chunked form and of
    its scan, all five gradients."""
    jax, jnp, _, jrefm = jref
    B = 1 if S == 1024 else 2
    arrays = _inputs(S * 7 + K + V, B, S, 2, K, V)
    cot = np.random.default_rng(S + 1).standard_normal(
        (B, S, 2, V)).astype(np.float32)
    ja = [jnp.asarray(a) for a in arrays]
    want = {
        "chunked": jax.grad(lambda *a: jnp.sum(
            jrefm.wkv6_chunked(*a, chunk=16) * cot),
            argnums=tuple(range(5)))(*ja),
        "scan": jax.grad(lambda *a: jnp.sum(jrefm.wkv6_scan(*a) * cot),
                         argnums=tuple(range(5)))(*ja)}
    got = tref.wkv6_grad(*(torch.tensor(a) for a in arrays),
                         torch.tensor(cot))
    for rname, grads in want.items():
        for name, g, w in zip(GRADS, got, grads):
            assert g.dtype == torch.float32 and g.shape == w.shape
            _gap(f"wkv6_grad {name} vs jax.grad of {rname} S={S} K={K} "
                 f"V={V}", g.numpy(), w, GRAD_TOL)


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


def stub_kernels(monkeypatch, calls=None):
    """Stand the plain versions in for both kernel entries of ops.py, on
    the CPU: the scan for the forward, wkv6_grad for the gradient."""
    def fwd(r, k, v, log_w, u, *, chunk):
        return tref.wkv6_scan(r, k, v, log_w, u)

    def grad(r, k, v, log_w, u, dO, *, chunk):
        if calls is not None:
            calls.append(chunk)
        return tref.wkv6_grad(r, k, v, log_w, u, dO)
    monkeypatch.setattr(tops, "wkv6_cuda", fwd)
    monkeypatch.setattr(tops, "wkv6_grad_cuda", grad)


def test_function_backward_is_the_chunked_gradient(monkeypatch):
    """WKV6Function's backward, run on the CPU with the plain versions
    standing in for the kernels: exactly the gradient entry's output, once
    a call, and the gradients of the plain chunked form."""
    calls = []
    stub_kernels(monkeypatch, calls)
    arrays = _inputs(16, 2, 48, 2, 16, 24)
    cot = torch.tensor(np.random.default_rng(17).standard_normal(
        (2, 48, 2, 24)).astype(np.float32))
    ta = [torch.tensor(a, requires_grad=True) for a in arrays]
    tb = [torch.tensor(a, requires_grad=True) for a in arrays]
    (tops.WKV6Function.apply(*ta, 16) * cot).sum().backward()
    assert calls == [16]
    want = tref.wkv6_grad(*(torch.tensor(a) for a in arrays), cot)
    for a, w in zip(ta, want):
        torch.testing.assert_close(a.grad, w, rtol=0, atol=0)
    (tref.wkv6_chunked(*tb, chunk=16) * cot).sum().backward()
    for name, a, b in zip(GRADS, ta, tb):
        _gap(f"WKV6Function grad {name} vs chunked autograd",
             a.grad.numpy(), b.grad.numpy(), GRAD_TOL)


def test_grad_wrapper_refuses_cpu_dtype_and_layout():
    arrays = [torch.tensor(a) for a in _inputs(24, 1, 32, 2, 16, 16)]
    dO = torch.ones((1, 32, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_kernel.wkv6_grad_cuda(*arrays, dO)
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv6_grad_cuda(*arrays, dO.double())
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv6_grad_cuda(arrays[0].bfloat16(), *arrays[1:], dO)
    strided = torch.ones((1, 32, 2, 32))[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv6_grad_cuda(*arrays, strided)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv6_cuda(*arrays[:3], arrays[3].transpose(2, 3),
                             arrays[4])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV6 kernel runs only on the "
                    "card")
    return torch.device("cuda")


KERNEL_SHAPES = [(2, 64, 3, 16, 24), (1, 80, 2, 64, 64), (2, 256, 4, 32, 32),
                 (1, 48, 1, 24, 16), (1, 1024, 2, 64, 64),
                 (1, 96, 3, 24, 40)]   # chip_smoke.py's ragged-K shape


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,V", KERNEL_SHAPES)
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
@pytest.mark.parametrize("B,S,H,K,V", KERNEL_SHAPES)
def test_grad_kernel_matches_closed_form_on_cuda(cuda_device, B, S, H, K, V):
    ta = [torch.tensor(a, device=cuda_device)
          for a in _inputs(25, B, S, H, K, V)]
    dO = torch.tensor(np.random.default_rng(26).standard_normal(
        (B, S, H, V)).astype(np.float32), device=cuda_device)
    before = wkv_kernel.grad_launches
    got = wkv_kernel.wkv6_grad_cuda(*ta, dO)
    torch.cuda.synchronize()
    assert wkv_kernel.grad_launches == before + 1
    want = tref.wkv6_grad(*ta, dO)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _gap(f"wkv6 gradient kernel {name} vs wkv6_grad at "
             f"{(B, S, H, K, V)}", g.cpu().numpy(), w.cpu().numpy(),
             GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 8])
def test_function_launches_once_each_way_on_cuda(cuda_device, chunk):
    """One forward launch and one gradient call (its two kernels) per call,
    at the model's chunk and a shorter one, on views with a non-contiguous
    head stride."""
    big = [torch.tensor(a, device=cuda_device, requires_grad=True)
           for a in _inputs(27, 2, 64, 4, 32, 32)]
    ta = [t[:, :, ::2] if t.dim() == 4 else t[::2] for t in big]
    gb = [t.detach().clone().requires_grad_() for t in ta]
    cot = torch.randn((2, 64, 2, 32), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    f0, b0 = wkv_kernel.launches, wkv_kernel.grad_launches
    out = tops.wkv6(*ta, chunk=chunk)
    assert (wkv_kernel.launches - f0, wkv_kernel.grad_launches - b0) == (1, 0)
    (out * cot).sum().backward()
    assert (wkv_kernel.launches - f0, wkv_kernel.grad_launches - b0) == (1, 1)
    (tref.wkv6_chunked(*gb, chunk=chunk) * cot).sum().backward()
    for name, a, b in zip(GRADS, big, gb):
        got = a.grad[:, :, ::2] if a.dim() == 4 else a.grad[::2]
        _gap(f"wkv6 kernels' gradient {name} vs chunked autograd, chunk "
             f"{chunk}", got.cpu().numpy(), b.grad.cpu().numpy(), GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,V", [(2, 64, 40, 64, 64),
                                       (1, 32, 300, 24, 40)])
def test_kernels_fill_several_waves_deterministically_on_cuda(
        cuda_device, B, S, H, K, V):
    """More blocks than the card holds at once: both kernels agree with the
    plain versions and give the same bits on a second call."""
    ta = [torch.tensor(a, device=cuda_device)
          for a in _inputs(28, B, S, H, K, V)]
    dO = torch.tensor(np.random.default_rng(29).standard_normal(
        (B, S, H, V)).astype(np.float32), device=cuda_device)
    out = wkv_kernel.wkv6_cuda(*ta)
    assert torch.equal(out, wkv_kernel.wkv6_cuda(*ta))
    torch.testing.assert_close(out, tref.wkv6_chunked(*ta), atol=ATOL,
                               rtol=RTOL)
    got = wkv_kernel.wkv6_grad_cuda(*ta, dO)
    again = wkv_kernel.wkv6_grad_cuda(*ta, dO)
    for name, g, a, w in zip(GRADS, got, again, tref.wkv6_grad(*ta, dO)):
        assert torch.equal(g, a), name
        _gap(f"wkv6 gradient kernel {name} at {(B, S, H, K, V)}",
             g.cpu().numpy(), w.cpu().numpy(), GRAD_TOL)


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
