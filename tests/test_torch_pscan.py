"""The chunk-level linear recurrence s_i = a_i ⊙ s_{i-1} + b_i of the port
(``repro_torch.models.layers.linear_recurrence_pscan`` / ``_prev_states``)
against the reference's associative scan, at the chunk counts of rwkv6's
long shapes, and its memory: a blocked closed form, linear in the number
of chunks as the reference's scan is. Same NumPy inputs made from a seed.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.rwkv6 import ops as tops
from repro_torch.models import layers as tlayers
from _jax_oracle import oracle_on_cpu  # noqa: E402

CHUNK = 16          # rwkv6's chunk: n = S / 16 chunks


@pytest.fixture(autouse=True, scope="module")
def _oracle_on_cpu():
    """The reference runs on the CPU at fp32 precision (tests/_jax_oracle.py)."""
    yield from oracle_on_cpu()


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rwkv6 import ref as jrwkv
    from repro.models import layers as jlayers
    return jax, jnp, jlayers, jrwkv


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _gap(what, got, want, bar):
    gap = _rel(got, want)
    print(f"parity-gap {what}: {gap:.2e} (bar {bar:.0e})")
    assert gap <= bar, (what, gap, bar)


def _chunk_inputs(seed, G, n, K, V):
    """a: the decay of a whole chunk, a product of CHUNK per-step decays
    w = exp(-exp(x)), x uniform over [-8, 0.5] (rwkv6 clips x to [-8,
    1.6]): channels from long memory (a near 1) to none (a near e^-26);
    b: the chunk's contribution."""
    rng = np.random.default_rng(seed)
    log_w = -np.exp(rng.uniform(-8.0, 0.5, (G, n, CHUNK, K)))
    a = np.exp(log_w.sum(2)).astype(np.float32)
    b = rng.standard_normal((G, n, K, V)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("S", [1024, 4096])
def test_prev_states_match_reference_scan(jref, S):
    """Both outputs of _prev_states (exclusive prefix states, final state)
    against the reference's associative scan at n = 64 and 256 chunks."""
    _, jnp, jlayers, _ = jref
    a, b = _chunk_inputs(S, 2, S // CHUNK, 8, 64)
    prev_j, final_j = jlayers._prev_states(jnp.asarray(a), jnp.asarray(b))
    prev_t, final_t = tlayers._prev_states(torch.tensor(a), torch.tensor(b))
    assert prev_t.dtype == torch.float32 and prev_t.shape == b.shape
    _gap(f"pscan prev states S={S}", prev_t.numpy(), prev_j, 1e-5)
    _gap(f"pscan final state S={S}", final_t.numpy(), final_j, 1e-5)


def test_wkv6_function_gradients_match_jax_grad_at_1024(jref, monkeypatch):
    """WKV6Function's backward at S = 1024, the plain versions standing in
    for both kernel entries (the scan for the forward, the closed-form
    gradient for the gradient kernel), against jax.grad of the reference's
    chunked form (whose chunk recurrence is the one above)."""
    jax, jnp, _, jrwkv = jref
    monkeypatch.setattr(tops, "wkv6_cuda", lambda *a, chunk:
                        tops.ref.wkv6_scan(*a))
    monkeypatch.setattr(tops, "wkv6_grad_cuda", lambda *a, chunk:
                        tops.ref.wkv6_grad(*a))
    B, S, H, K, V = 1, 1024, 2, 16, 16
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = (f(B, S, H, K), f(B, S, H, K), f(B, S, H, V),
              -np.exp(np.clip(f(B, S, H, K), -8, 1.6)).astype(np.float32),
              (f(H, K) * 0.3).astype(np.float32))
    cot = f(B, S, H, V)

    def jloss(*args):
        return jnp.sum(jrwkv.wkv6_chunked(*args, chunk=CHUNK) * cot)

    gj = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(x) for x in arrays))
    ta = [torch.tensor(x, requires_grad=True) for x in arrays]
    (tops.WKV6Function.apply(*ta, CHUNK) * torch.tensor(cot)).sum().backward()
    for name, t, g in zip(("r", "k", "v", "log_w", "u"), ta, gj):
        _gap(f"WKV6Function grad {name} S={S}", t.grad.numpy(), g, 1e-5)


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op produces."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numels.append(t.numel())
        return out


@pytest.mark.parametrize("n,K,V", [(4096, 4, 64), (300, 4, 64), (256, 8, 5)])
def test_pscan_memory_is_linear_in_chunks(n, K, V):
    """No tensor produced during one call holds more than 4x the elements
    of the (G, n, K, V) states it returns (the old (G, n, n, K) closed form
    held n / V times as many: 64x at n = 4096, V = 64). V below the
    smallest block (16) is held to the block's share, 16 / V."""
    a, b = _chunk_inputs(n + K + V, 1, n, K, V)
    sizes = _Sizes()
    with sizes:
        out = tlayers.linear_recurrence_pscan(torch.tensor(a),
                                              torch.tensor(b))
    assert out.shape == b.shape
    cap = 4 * max(1, tlayers.PSCAN_MIN_BLOCK // V) * b.size
    print(f"pscan n={n}: largest tensor {max(sizes.numels)} elements, "
          f"output {b.size}")
    assert max(sizes.numels) <= cap, (max(sizes.numels), b.size)
    # and the result is the recurrence's
    s = torch.zeros((1, K, V), dtype=torch.float64)
    want = []
    for i in range(n):
        s = torch.tensor(a[:, i, :, None], dtype=torch.float64) * s \
            + torch.tensor(b[:, i], dtype=torch.float64)
        want.append(s)
    _gap(f"pscan vs loop n={n}", out.numpy(), torch.stack(want, 1).numpy(),
         1e-5)


def _loop(a, b):
    """The recurrence step by step in float64: the states restart from b
    where a = 0."""
    s = np.zeros_like(b[:, 0], dtype=np.float64)
    out = []
    for i in range(a.shape[1]):
        s = a[:, i].reshape(a[:, i].shape + (1,) * (b.ndim - 3)) * s + b[:, i]
        out.append(s)
    return np.stack(out, 1)


def test_prev_states_with_an_exact_zero_decay(jref):
    """An a that is exactly 0 (a chunk decay that underflowed) restarts the
    state from b, as the loop's and the reference's associative scan's do:
    the port's states are finite (log 0 used to give -inf - -inf = NaN)
    and equal both within 1e-6."""
    _, jnp, jlayers, _ = jref
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 1.0, (2, 16, 4)).astype(np.float32)
    a[0, 6, 1] = a[1, 0, 3] = a[1, 15, 0] = 0.0
    b = rng.standard_normal((2, 16, 4, 3, 5)).astype(np.float32)
    prev_j, final_j = jlayers._prev_states(jnp.asarray(a), jnp.asarray(b),
                                           extra_dims=2)
    prev_t, final_t = tlayers._prev_states(torch.tensor(a), torch.tensor(b),
                                           extra_dims=2)
    assert torch.isfinite(prev_t).all() and torch.isfinite(final_t).all()
    incl = _loop(a, b)
    _gap("pscan a=0 prev states vs reference", prev_t.numpy(), prev_j, 1e-6)
    _gap("pscan a=0 final state vs reference", final_t.numpy(), final_j,
         1e-6)
    _gap("pscan a=0 final state vs loop", final_t.numpy(), incl[:, -1], 1e-6)
    _gap("pscan a=0 prev states vs loop", prev_t.numpy()[:, 1:],
         incl[:, :-1], 1e-6)
    # right after the zero the state is the step's own input
    np.testing.assert_allclose(
        tlayers.linear_recurrence_pscan(torch.tensor(a), torch.tensor(b),
                                        extra_dims=2)[0, 6, 1].numpy(),
        b[0, 6, 1], rtol=0, atol=1e-7)


def test_ssd_chunked_with_underflowing_chunk_decays(jref):
    """Mamba2's SSD at zamba2's chunk of 128, A from -1 to -16 and dt from
    its dt_bias init: most chunk decays exp(Σ dt·A) are exactly 0 in fp32.
    The port's output, final state and gradients are finite and within
    1e-4 of the reference's (jax.grad for the gradients)."""
    jax, jnp, jlayers, _ = jref
    Bn, S, H, P, N = 1, 512, 8, 16, 8
    rng = np.random.default_rng(11)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, S, H))
                         + rng.uniform(-4.0, -2.0, H))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    x = rng.standard_normal((Bn, S, H, P)).astype(np.float32)
    Bc = rng.standard_normal((Bn, S, N)).astype(np.float32)
    Cc = rng.standard_normal((Bn, S, N)).astype(np.float32)
    cum = (dt * A).reshape(Bn, S // 128, 128, H).sum(2)
    zeros = int((np.exp(cum) == 0.0).sum())
    print(f"ssd chunk decays exactly 0 in fp32: {zeros} of {cum.size}")
    assert zeros >= cum.size // 4
    args = (x, dt, A, Bc, Cc)
    yj, sj = jlayers.ssd_chunked(*(jnp.asarray(v) for v in args), chunk=128,
                                 return_state=True)
    ta = [torch.tensor(v, requires_grad=True) for v in args]
    yt, st = tlayers.ssd_chunked(*ta, chunk=128, return_state=True)
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    _gap("ssd_chunked underflowing decays y", yt.detach().numpy(), yj, 1e-4)
    _gap("ssd_chunked underflowing decays state", st.detach().numpy(), sj,
         1e-4)
    cot_y = rng.standard_normal(yt.shape).astype(np.float32)
    cot_s = rng.standard_normal(st.shape).astype(np.float32)

    def jloss(*v):
        y, s = jlayers.ssd_chunked(*v, chunk=128, return_state=True)
        return jnp.sum(y * cot_y) + jnp.sum(s * cot_s)

    gj = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(v) for v in args))
    ((yt * torch.tensor(cot_y)).sum()
     + (st * torch.tensor(cot_s)).sum()).backward()
    for name, t, g in zip(("x", "dt", "A", "B", "C"), ta, gj):
        assert torch.isfinite(t.grad).all(), name
        _gap(f"ssd_chunked underflowing decays grad {name}", t.grad.numpy(),
             g, 1e-4)
