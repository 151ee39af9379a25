"""Flash attention: the port (repro_torch.kernels.flash_attention) against
the JAX reference (repro.kernels.flash_attention), same NumPy inputs made
from a seed.

On the CPU the port's `flash_attention` runs its plain version; the
reference runs its Pallas kernel in interpret mode, over the grid of its
own tests (tests/test_kernels.py). Bars are the reference's: 2e-5 (atol and
rtol) in fp32, 2e-2 in bf16. Ragged lengths, which the Pallas wrapper does
not take (it asserts divisibility), are held against the reference's
``backend="ref"``. The fp32 kernel's 3xTF32 arithmetic
(``kernel.flash_3xtf32``) is held against the same at the fp32 bar. The
CUDA kernels are held against the plain version on the card by the
`cuda`-marked tests.
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


def _emulated(arrays, **kw):
    """The fp32 kernel's arithmetic (kernel.flash_3xtf32) in model layout."""
    q, k, v = (torch.tensor(a).transpose(1, 2) for a in arrays)
    return fa_kernel.flash_3xtf32(q, k, v, **kw).transpose(1, 2).numpy()


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,q_offset,window,softcap", [
    (1, 4, 2, 128, 128, 64, 0, 0, 0.0),       # GQA, two key tiles of 64
    (2, 4, 1, 128, 128, 128, 0, 48, 0.0),     # MQA, a window across tiles
    (1, 4, 2, 64, 64, 256, 0, 0, 50.0),       # gemma2's hd and softcap
    (1, 8, 4, 96, 96, 256, 0, 40, 50.0),      # ... with its window
    (1, 4, 4, 64, 256, 64, 192, 0, 0.0),      # q at the tail (q_offset)
    (2, 4, 2, 64, 64, 128, 0, 0, 30.0),       # softcap 30 at hd 128
])
def test_3xtf32_emulation_matches_pallas_interpret(jref, B, H, KV, Sq, Sk,
                                                   hd, q_offset, window,
                                                   softcap):
    """The fp32 kernel's 3xTF32 arithmetic against the Pallas kernel in
    interpret mode, at the reference's fp32 bar (2e-5 abs + rel)."""
    jnp, jops = jref
    arrays = _qkv(11, B, Sq, Sk, H, KV, hd)
    kw = dict(q_offset=q_offset, window=window, softcap=softcap)
    out_j = jops.flash_attention(*(jnp.asarray(a) for a in arrays),
                                 backend="interpret", **kw)
    np.testing.assert_allclose(_emulated(arrays, **kw), np.asarray(out_j),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,q_offset,window,softcap,causal", [
    (2, 100, 100, 4, 2, 64, 0, 0, 0.0, True),     # not a tile multiple
    (1, 37, 100, 4, 1, 64, 63, 0, 0.0, True),     # MQA, q at the tail
    (2, 77, 77, 2, 2, 128, 0, 20, 50.0, True),    # window and softcap
    (1, 45, 70, 8, 4, 256, 25, 30, 50.0, True),   # hd 256, all masks
    (1, 50, 83, 4, 2, 256, 0, 0, 0.0, False),     # not causal: every key
    (1, 20, 20, 4, 2, 64, -8, 0, 0.0, True),      # rows that see no key
])
def test_3xtf32_emulation_matches_reference_ragged(jref, B, Sq, Sk, H, KV,
                                                   hd, q_offset, window,
                                                   softcap, causal):
    """Ragged lengths (which the Pallas wrapper does not take) against the
    reference's plain version, at the fp32 bar."""
    jnp, jops = jref
    arrays = _qkv(12, B, Sq, Sk, H, KV, hd)
    kw = dict(q_offset=q_offset, window=window, softcap=softcap,
              causal=causal)
    out_j = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in arrays), backend="ref", **kw))
    got = _emulated(arrays, **kw)
    if q_offset < 0:   # the jnp oracle averages v where no key is visible;
        # the kernels give 0 (the Pallas kernel's l == 0 guard)
        assert np.all(got[:, :-q_offset] == 0)
        got, out_j = got[:, -q_offset:], out_j[:, -q_offset:]
    np.testing.assert_allclose(got, out_j, atol=2e-5, rtol=2e-5)


def test_row_without_visible_key_gives_zero():
    """Rows at negative positions see no key under the causal mask: 0, as
    the Pallas kernel's l == 0 guard gives (the jnp oracle averages v)."""
    q, k, v = (torch.tensor(a) for a in _qkv(5, 1, 16, 16, 2, 1, 64))
    out = tops.flash_attention(q, k, v, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    assert torch.all(out[:, 4:].abs().sum(-1) > 0)


def test_dispatch_and_validation():
    q, k, v = (torch.tensor(a) for a in _qkv(6, 1, 8, 8, 2, 2, 64))
    before = fa_kernel.launches()
    assert torch.equal(tops.flash_attention(q, k, v),
                       tops.flash_attention(q, k, v, backend="ref"))
    assert fa_kernel.launches() == before        # CPU: the plain version
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


def _entry_spy(monkeypatch):
    """Replace both C entry points with recorders: {route: [args, ...]}."""
    calls = {fa_kernel.BF16_ROUTE: [], fa_kernel.F32_ROUTE: []}

    def entry(route):
        def fn(*args):
            calls[route].append(args)
            return 0
        return fn
    monkeypatch.setattr(fa_kernel, "_entry", entry)
    return calls


def _model_views(dtype, B=2, Sq=40, Sk=56, H=4, KV=2, hd=64):
    """q, k, v as the model hands them: (B, S, heads, hd) transposed."""
    q, k, v = (torch.tensor(a).to(dtype)
               for a in _qkv(9, B, Sq, Sk, H, KV, hd))
    return tuple(t.transpose(1, 2) for t in (q, k, v))


@pytest.mark.parametrize("dtype,route,kw", [
    (torch.bfloat16, "bf16_wgmma", dict(causal=True, window=0, softcap=0.0,
                                        q_offset=0)),
    (torch.bfloat16, "bf16_wgmma", dict(causal=True, window=24, softcap=50.0,
                                        q_offset=16)),
    (torch.bfloat16, "bf16_wgmma", dict(causal=False, window=0, softcap=0.0,
                                        q_offset=-8)),
    (torch.float32, "f32_3xtf32", dict(causal=True, window=0, softcap=0.0,
                                       q_offset=0)),
    (torch.float32, "f32_3xtf32", dict(causal=True, window=24, softcap=50.0,
                                       q_offset=16)),
])
def test_route_by_dtype(monkeypatch, dtype, route, kw):
    """bf16 reaches the wgmma entry point and fp32 the 3xTF32 one, with the
    shape, the model layout's strides (no copy), the output's strides and
    the flags; each route counts its own launches."""
    calls = _entry_spy(monkeypatch)
    q, k, v = _model_views(dtype)
    before = dict(fa_kernel.route_launches)
    out = fa_kernel.launch_on_stream(q, k, v, 7, **kw)
    other = ({"bf16_wgmma", "f32_3xtf32"} - {route}).pop()
    assert len(calls[route]) == 1 and calls[other] == []
    args = calls[route][0]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    rest = args[4:]
    B, H, Sq, hd = q.shape
    assert rest[:6] == (B, H, k.shape[1], Sq, k.shape[2], hd)
    assert list(rest[6]) == [s for t in (q, k, v, out)
                             for s in t.stride()[:3]]
    assert rest[7:] == (int(kw["causal"]), kw["window"],
                        kw["softcap"], kw["q_offset"], 7)
    assert out.dtype == dtype and out.shape == q.shape
    assert out.stride() == q.stride()           # q's (model) layout
    assert fa_kernel.route_launches[route] == before[route] + 1
    assert fa_kernel.route_launches[other] == before[other]


@pytest.mark.parametrize("rc,message", [
    (-1, "cuTensorMapEncodeTiled is not available"),
    (-1000 - 1, "cuTensorMapEncodeTiled failed, CUresult 1"),
    (999, "launch failed: CUDA error 999"),     # cudaErrorUnknown
    (1, "launch failed: CUDA error 1"),
])
def test_entry_error_codes(monkeypatch, rc, message):
    """The bf16 entry point's own codes are negative, and every CUDA error
    (positive) keeps its own message; each raises and counts no launch."""
    monkeypatch.setattr(fa_kernel, "_entry", lambda route: lambda *a: rc)
    q, k, v = _model_views(torch.bfloat16)
    before = fa_kernel.launches()
    with pytest.raises(RuntimeError, match=message):
        fa_kernel.launch_on_stream(q, k, v, 0)
    assert fa_kernel.launches() == before


def _offset_view(B, H, S, hd, offset):
    """A (B, H, S, hd) view `offset` elements into its storage."""
    base = torch.zeros(B * H * S * hd + 16, dtype=torch.bfloat16)
    return base[offset:offset + B * H * S * hd].view(B, H, S, hd)


@pytest.mark.parametrize("case,copies", [
    ("model layout view", False),
    ("contiguous", False),
    ("head slice of a wider tensor", False),
    ("odd storage offset", True),
    ("storage offset 4 (8 bytes)", True),
    ("row stride 68", True),
    ("expanded kv heads (stride 0)", True),
    ("size-1 dims with odd strides", False),
])
def test_tma_predicate(monkeypatch, case, copies):
    """tma_strides' verdict on each view, and what the bf16 route does with
    it: pass the view as it lies, or copy it (never hand TMA a view it
    cannot address). The fp32 route copies none of them."""
    B, H, S, hd = 2, 4, 24, 64
    t = {
        "model layout view": lambda: torch.zeros(
            B, S, H, hd, dtype=torch.bfloat16).transpose(1, 2),
        "contiguous": lambda: torch.zeros(B, H, S, hd, dtype=torch.bfloat16),
        "head slice of a wider tensor": lambda: torch.zeros(
            B, S, H + 2, hd, dtype=torch.bfloat16).transpose(1, 2)[:, :H],
        "odd storage offset": lambda: _offset_view(B, H, S, hd, 1),
        "storage offset 4 (8 bytes)": lambda: _offset_view(B, H, S, hd, 4),
        "row stride 68": lambda: torch.zeros(
            B, H, S, 68, dtype=torch.bfloat16)[..., :hd],
        "expanded kv heads (stride 0)": lambda: torch.zeros(
            B, 1, S, hd, dtype=torch.bfloat16).expand(B, H, S, hd),
        "size-1 dims with odd strides": lambda: torch.zeros(
            1, 1, S, hd, dtype=torch.bfloat16).as_strided(
                (1, 1, S, hd), (3, 5, hd, 1)),
    }[case]()
    st = fa_kernel.tma_strides(t)
    assert (st is None) == copies
    if st is not None:
        assert all(s > 0 and s % 8 == 0 for s in st)
        assert [s for n, s in zip(t.shape, st) if n > 1] == \
            [s for n, s in zip(t.shape[:3], t.stride()) if n > 1]
    calls = _entry_spy(monkeypatch)
    q = t
    k = v = torch.zeros(t.shape[0], 1, S, hd, dtype=torch.bfloat16)
    fa_kernel.launch_on_stream(q, k, v, 0)
    args = calls["bf16_wgmma"][0]
    passed_q = args[0] == q.data_ptr()
    assert passed_q != copies
    q_strides = list(args[10])[:3]
    fresh = q.clone(memory_format=torch.contiguous_format)
    assert q_strides == list(fa_kernel.tma_strides(fresh) if copies else st)
    assert args[0] % 16 == 0
    fa_kernel.launch_on_stream(q.float(), k.float(), v.float(), 0)
    assert len(calls["f32_3xtf32"]) == 1


def _visible_mask(Sq, Sk, causal, window, q_offset):
    """ref.mha_reference's mask, (Sq, Sk) booleans."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


@pytest.mark.parametrize("bq,bk", [(64, 128), (64, 64), (128, 128),
                                   (128, 64), (16, 64), (16, 32), (64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_kinds_cover_the_mask(bq, bk, causal):
    """Exhaustively over ragged shapes, windows that cut tiles and negative
    q_offset: every visible pair lies in a FULL or MASKED tile, no pair of
    a FULL tile is masked, a SKIP tile holds none, and each row block's
    non-SKIP tiles are one run (the block loads a contiguous range)."""
    checked = {fa_kernel.SKIP: 0, fa_kernel.FULL: 0, fa_kernel.MASKED: 0}
    for Sq in (1, 37, 64, 128, 200, 256):
        for Sk in (1, 50, 128, 300):
            for window in (0, 1, 50, 128, 4096):
                for q_offset in (0, -40, 63, Sk - Sq, 1792):
                    mask = _visible_mask(Sq, Sk, causal, window, q_offset)
                    kinds = fa_kernel.tile_kinds(Sq, Sk, bq, bk, causal,
                                                 window, q_offset)
                    assert kinds.shape == (-(-Sq // bq), -(-Sk // bk))
                    for qt, row in enumerate(kinds):
                        live = np.flatnonzero(row != fa_kernel.SKIP)
                        if live.size:
                            assert np.all(np.diff(live) == 1)
                        for kt, kind in enumerate(row):
                            tile = mask[qt * bq:(qt + 1) * bq,
                                        kt * bk:(kt + 1) * bk]
                            checked[kind] += 1
                            if kind == fa_kernel.SKIP:
                                assert not tile.any()
                            elif kind == fa_kernel.FULL:
                                assert tile.all()
                                assert tile.shape[1] == bk  # no Sk tail
    assert all(n > 0 for n in checked.values()), checked


def test_warpgroup_tiles_lie_in_the_block_range():
    """A warpgroup (WG_ROWS rows) never needs a key tile its block
    (BQ rows) does not load."""
    bq, wg = fa_kernel.BQ, fa_kernel.WG_ROWS
    for hd, bk in fa_kernel.BK.items():
        for Sq, Sk, window, q_offset in [(300, 300, 0, 0), (333, 700, 100, 0),
                                         (256, 2048, 0, 1792),
                                         (96, 96, 0, -40), (1, 1, 0, 0)]:
            blocks = fa_kernel.tile_kinds(Sq, Sk, bq, bk, True, window,
                                          q_offset)
            groups = fa_kernel.tile_kinds(Sq, Sk, wg, bk, True, window,
                                          q_offset)
            for g, row in enumerate(groups):
                need = row != fa_kernel.SKIP
                assert not (need & (blocks[g // 2] == fa_kernel.SKIP)).any()


def test_warp_tiles_lie_in_the_block_range_f32():
    """The fp32 kernel's warps (F32_WARP_ROWS rows) never need a key tile
    their block (F32_BQ rows) does not load, at each head dim's F32_BK."""
    bq, wr = fa_kernel.F32_BQ, fa_kernel.F32_WARP_ROWS
    for hd, bk in fa_kernel.F32_BK.items():
        for Sq, Sk, window, q_offset, causal in [
                (300, 300, 0, 0, True), (333, 700, 100, 0, True),
                (256, 2048, 0, 1792, True), (96, 96, 0, -40, True),
                (1, 1, 0, 0, True), (5, 5, 0, 0, True),
                (130, 195, 70, 65, False)]:
            blocks = fa_kernel.tile_kinds(Sq, Sk, bq, bk, causal, window,
                                          q_offset)
            warps = fa_kernel.tile_kinds(Sq, Sk, wr, bk, causal, window,
                                         q_offset)
            for w, row in enumerate(warps):
                need = row != fa_kernel.SKIP
                assert not (need & (blocks[w * wr // bq]
                                    == fa_kernel.SKIP)).any()


@pytest.mark.parametrize("case,copies", [
    ("model layout view", False),
    ("head slice of a wider tensor", False),
    ("storage offset 2 (8 bytes)", True),
    ("row stride 66", True),
    ("size-1 dims with odd strides", False),
])
def test_f32_route_copies_what_cp_async_cannot_read(monkeypatch, case,
                                                    copies):
    """The fp32 kernel loads 16-byte pieces (cp.async): a view whose base
    or strides are not 16-byte multiples (4 fp32 elements) is copied first,
    any other view is passed as it lies, with its own strides."""
    B, H, S, hd = 2, 4, 24, 64
    t = {
        "model layout view": lambda: torch.zeros(B, S, H, hd).transpose(1, 2),
        "head slice of a wider tensor": lambda: torch.zeros(
            B, S, H + 1, hd).transpose(1, 2)[:, :H],
        "storage offset 2 (8 bytes)": lambda: torch.zeros(
            B * H * S * hd + 8)[2:2 + B * H * S * hd].view(B, H, S, hd),
        "row stride 66": lambda: torch.zeros(B, H, S, 66)[..., :hd],
        "size-1 dims with odd strides": lambda: torch.zeros(
            1, 1, S, hd).as_strided((1, 1, S, hd), (3, 5, hd, 1)),
    }[case]()
    assert (fa_kernel.tma_strides(t) is None) == copies
    calls = _entry_spy(monkeypatch)
    k = v = torch.zeros(t.shape[0], 1, S, hd)
    fa_kernel.launch_on_stream(t, k, v, 0)
    args = calls["f32_3xtf32"][0]
    assert (args[0] == t.data_ptr()) != copies
    assert args[0] % 16 == 0
    assert all(s % 4 == 0 for n, s in zip(t.shape, list(args[10])[:3])
               if n > 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,q_offset,window,softcap,causal", [
    (2, 256, 256, 8, 2, 64, 0, 0, 0.0, True),
    (1, 1000, 1000, 4, 2, 64, 0, 0, 0.0, True),     # ragged
    (1, 512, 512, 8, 4, 256, 0, 128, 50.0, True),   # gemma2 local layer
    (1, 512, 512, 8, 4, 256, 0, 0, 50.0, True),     # gemma2 global layer
    (2, 192, 192, 8, 8, 128, 0, 0, 0.0, True),
    (1, 64, 300, 4, 1, 64, 236, 0, 0.0, True),      # q_offset, MQA
    (1, 96, 96, 4, 2, 64, -40, 0, 0.0, True),       # rows that see no key: 0
    # every tile kind of the bf16 wgmma kernel (BQ 128, BK 128 / 64 at hd 256)
    (1, 1, 1, 2, 1, 64, 0, 0, 0.0, True),           # Sq = Sk = 1
    (2, 50, 70, 4, 2, 64, 20, 0, 0.0, True),        # Sk < BK, q tail
    (1, 333, 333, 4, 2, 64, 0, 0, 0.0, True),       # not a multiple of 64, 128
    (1, 300, 300, 4, 2, 64, 0, 100, 0.0, True),     # window cuts inside tiles
    (2, 257, 257, 8, 1, 64, 0, 0, 30.0, True),      # MQA (KV = 1), softcap
    (1, 201, 201, 4, 2, 128, 0, 77, 0.0, True),     # hd 128 ragged, window
    (1, 130, 195, 4, 4, 256, 65, 0, 50.0, True),    # hd 256 ragged, softcap
    (2, 256, 2048, 8, 2, 64, 1792, 0, 0.0, True),   # q tail at q_offset
    # not causal: every key up to Sk - 1; a window cuts only below
    (1, 300, 300, 4, 2, 64, 0, 100, 0.0, False),    # window cuts inside tiles
    (1, 333, 500, 4, 2, 128, 0, 0, 0.0, False),     # ragged, Sk > Sq
    (1, 130, 195, 4, 4, 256, 65, 70, 50.0, False),  # hd 256, window, softcap
    # a B = 1 prompt of a few tokens: one warp's m16 tile, mostly empty
    (1, 5, 5, 8, 4, 256, 0, 0, 50.0, True),
    (1, 3, 3, 32, 8, 64, 0, 0, 0.0, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda_device, B, Sq, Sk, H, KV, hd,
                                      q_offset, window, softcap, causal,
                                      dtype):
    """The hand-written kernel against its plain version on the same CUDA
    inputs; the reference's bars, 2e-5 fp32 and 2e-2 bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.tensor(a, device=cuda_device).to(dtype)
               for a in _qkv(7, B, Sq, Sk, H, KV, hd))
    kw = dict(q_offset=q_offset, window=window, softcap=softcap,
              causal=causal)
    before = fa_kernel.launches()
    out = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.launches() == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    ref = tops.flash_attention(q, k, v, backend="ref", **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if q_offset < 0:
        assert torch.all(out[:, :-q_offset] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided model-layout q",
                                  "misaligned storage offset"])
def test_bf16_kernel_views_on_cuda(cuda_device, case):
    """The bf16 route on views: a non-contiguous model-layout q (a head
    slice of a wider tensor) is read in place by TMA; a q whose storage
    offset breaks TMA's 16-byte alignment is copied first. Both agree with
    the plain version and launch the wgmma kernel once."""
    B, Sq, Sk, H, KV, hd = 2, 200, 200, 4, 2, 64
    qn, kn, vn = _qkv(10, B, Sq, Sk, H, KV, hd)
    if case == "strided model-layout q":
        wide = np.concatenate([qn, qn[:, :, :2]], axis=2)   # H + 2 heads
        q = torch.tensor(wide, device=cuda_device).bfloat16()[:, :, :H]
        assert not q.is_contiguous()
    else:
        flat = torch.zeros(qn.size + 8, device=cuda_device,
                           dtype=torch.bfloat16)
        q = flat[3:3 + qn.size].view(qn.shape)
        q.copy_(torch.tensor(qn))
        assert fa_kernel.tma_strides(q.transpose(1, 2)) is None
    k, v = (torch.tensor(a, device=cuda_device).bfloat16() for a in (kn, vn))
    before = fa_kernel.route_launches["bf16_wgmma"]
    out = tops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_kernel.route_launches["bf16_wgmma"] == before + 1
    ref = tops.flash_attention(q, k, v, backend="ref")
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,q_offset,window,softcap", [
    (1, 700, 700, 8, 4, 256, 0, 300, 50.0),     # gemma2 local, cut down
    (2, 333, 333, 8, 2, 64, 0, 0, 0.0),
    (1, 64, 400, 4, 1, 128, 336, 0, 0.0),
])
def test_f32_kernel_is_repeatable_and_emulated_on_cuda(cuda_device, B, Sq,
                                                        Sk, H, KV, hd,
                                                        q_offset, window,
                                                        softcap):
    """The fp32 kernel gives the same bits on every call (a fixed order of
    sums, no atomics), and agrees with its 3xTF32 emulation on the same
    CUDA inputs at the fp32 bar."""
    q, k, v = (torch.tensor(a, device=cuda_device)
               for a in _qkv(13, B, Sq, Sk, H, KV, hd))
    kw = dict(q_offset=q_offset, window=window, softcap=softcap)
    before = fa_kernel.route_launches["f32_3xtf32"]
    outs = [tops.flash_attention(q, k, v, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert fa_kernel.route_launches["f32_3xtf32"] == before + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    emu = fa_kernel.flash_3xtf32(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), **kw).transpose(1, 2)
    torch.testing.assert_close(outs[0], emu, atol=2e-5, rtol=2e-5)
