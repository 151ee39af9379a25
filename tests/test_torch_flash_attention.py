"""Flash attention: the port (repro_torch.kernels.flash_attention) against
the JAX reference (repro.kernels.flash_attention), same NumPy inputs made
from a seed.

On the CPU the port's `flash_attention` runs its plain version; the
reference runs its Pallas kernel in interpret mode, over the grid of its
own tests (tests/test_kernels.py). Bars are the reference's: 2e-5 (atol and
rtol) in fp32, 2e-2 in bf16. Ragged lengths, which the Pallas wrapper does
not take (it asserts divisibility), are held against the reference's
``backend="ref"``. The CUDA kernel is held against the plain version on the
card by the `cuda`-marked tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as tops
from _jax_oracle import oracle_on_cpu  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(scope="module")
def jref():
    """The reference's ops module (skips where JAX is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import ops as jops
    return jnp, jops


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


def _both(jref, arrays, dtype, **kw):
    """(port plain output, reference output) as fp32 NumPy arrays."""
    jnp, jops = jref
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    backend = kw.pop("jax_backend", "interpret")
    out_j = jops.flash_attention(*(jnp.asarray(a, jd) for a in arrays),
                                 backend=backend, **kw)
    out_t = tops.flash_attention(*(torch.tensor(a).to(td) for a in arrays),
                                 **kw)
    assert out_t.dtype == td and tuple(out_t.shape) == out_j.shape
    return out_t.float().numpy(), np.asarray(out_j, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == "bf16" else 2e-5


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 4, 4, 64, 32),       # MHA
    (2, 8, 2, 128, 64),      # GQA 4:1
    (1, 8, 8, 256, 128),     # long-ish head
    (2, 4, 1, 64, 64),       # MQA
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_pallas_interpret_shapes(jref, B, H, KV, S, hd, dtype):
    t, j = _both(jref, _qkv(0, B, S, S, H, KV, hd), dtype)
    np.testing.assert_allclose(t, j, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 0.0), (0, 50.0),
                                            (48, 30.0)])
def test_plain_matches_pallas_interpret_variants(jref, window, softcap):
    t, j = _both(jref, _qkv(1, 2, 128, 128, 8, 4, 64), "fp32",
                 window=window, softcap=softcap)
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Sq,Sk,q_offset,window", [(64, 256, 192, 0),
                                                   (128, 256, 128, 64)])
def test_plain_matches_pallas_interpret_q_offset(jref, Sq, Sk, q_offset,
                                                 window):
    t, j = _both(jref, _qkv(2, 1, Sq, Sk, 4, 2, 64), "fp32",
                 q_offset=q_offset, window=window, softcap=50.0)
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5)


def test_plain_matches_pallas_blocks_smaller_than_seq(jref):
    jnp, _ = jref
    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    q, k, v = _qkv(3, 1, 512, 512, 2, 2, 64)
    out_j = flash_attention_pallas(
        *(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
        block_q=128, block_k=128, interpret=True).swapaxes(1, 2)
    out_t = tops.flash_attention(*(torch.tensor(a) for a in (q, k, v)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,q_offset,window,softcap", [
    (2, 100, 100, 4, 2, 64, 0, 0, 0.0),       # ragged: not a block multiple
    (1, 37, 100, 4, 1, 32, 63, 0, 0.0),       # Sq < Sk, q at the tail
    (2, 77, 77, 2, 2, 128, 0, 20, 50.0),      # ragged, window and softcap
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_matches_reference_ragged(jref, B, Sq, Sk, H, KV, hd, q_offset,
                                        window, softcap, dtype):
    t, j = _both(jref, _qkv(4, B, Sq, Sk, H, KV, hd), dtype,
                 jax_backend="ref", q_offset=q_offset, window=window,
                 softcap=softcap)
    np.testing.assert_allclose(t, j, atol=_tol(dtype), rtol=_tol(dtype))


def test_row_without_visible_key_gives_zero():
    """Rows at negative positions see no key under the causal mask: 0, as
    the Pallas kernel's l == 0 guard gives (the jnp oracle averages v)."""
    q, k, v = (torch.tensor(a) for a in _qkv(5, 1, 16, 16, 2, 1, 64))
    out = tops.flash_attention(q, k, v, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    assert torch.all(out[:, 4:].abs().sum(-1) > 0)


def test_dispatch_and_validation():
    q, k, v = (torch.tensor(a) for a in _qkv(6, 1, 8, 8, 2, 2, 64))
    before = fa_kernel.launches
    assert torch.equal(tops.flash_attention(q, k, v),
                       tops.flash_attention(q, k, v, backend="ref"))
    assert fa_kernel.launches == before        # CPU: the plain version
    with pytest.raises(ValueError, match="backend"):
        tops.flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2))


def test_kernel_route_refuses_autograd(monkeypatch):
    """The kernel has no backward: on the kernel route, a call that autograd
    records through q, k or v raises instead of returning an output with no
    gradient. Meta tensors take the kernel route here (they are not CPU
    tensors), with the launch patched out."""
    calls = []
    monkeypatch.setattr(tops, "flash_attention_cuda",
                        lambda q, *a, **kw: calls.append(1) or q)
    q, k, v = (torch.tensor(a).to("meta") for a in _qkv(8, 1, 8, 8, 2, 2, 64))
    with pytest.raises(RuntimeError, match="no backward.*ROADMAP"):
        tops.flash_attention(q.requires_grad_(), k, v)
    assert calls == []
    with torch.no_grad():
        tops.flash_attention(q, k, v)
    tops.flash_attention(q.detach(), k, v)
    assert calls == [1, 1]
    with pytest.raises(RuntimeError, match="no backward"):
        tops.flash_attention(q.detach(), k, v.requires_grad_())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,q_offset,window,softcap", [
    (2, 256, 256, 8, 2, 64, 0, 0, 0.0),
    (1, 1000, 1000, 4, 2, 64, 0, 0, 0.0),     # ragged
    (1, 512, 512, 8, 4, 256, 0, 128, 50.0),   # gemma2 local layer
    (1, 512, 512, 8, 4, 256, 0, 0, 50.0),     # gemma2 global layer
    (2, 192, 192, 8, 8, 128, 0, 0, 0.0),
    (1, 64, 300, 4, 1, 64, 236, 0, 0.0),      # q_offset, MQA
    (1, 96, 96, 4, 2, 64, -40, 0, 0.0),       # rows that see no key give 0
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda_device, B, Sq, Sk, H, KV, hd,
                                      q_offset, window, softcap, dtype):
    """The hand-written kernel against its plain version on the same CUDA
    inputs; the reference's bars, 2e-5 fp32 and 2e-2 bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.tensor(a, device=cuda_device).to(dtype)
               for a in _qkv(7, B, Sq, Sk, H, KV, hd))
    kw = dict(q_offset=q_offset, window=window, softcap=softcap)
    before = fa_kernel.launches
    out = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    ref = tops.flash_attention(q, k, v, backend="ref", **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if q_offset < 0:
        assert torch.all(out[:, :-q_offset] == 0)
