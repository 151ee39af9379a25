"""The modality-prefix families and MLA on the card: the flash kernel at
the two layouts these families give it (musicgen-large's MHA (4, 32, 32,
T = 64 + 2048 = 2112, hd 64), whose last key tile is ragged and whose key
axis holds the prefix; chameleon-34b's GQA 8:1 at hd 128, (2, 64, 8,
T = 256 + 2048 = 2304)) against its plain version in both dtypes, at the
reference's bars (2e-5 fp32, 2e-2 bf16); a reduced musicgen's fp32 prefill
with its prefix through the kernel against the plain path; and the
captured decode step, bit for bit the eager one, on chameleon's qk-norm
and on deepseek's latent cache. These tests need a CUDA device and skip
without one; the reference's parity tests are tests/test_torch_modality.py
and tests/test_torch_mla.py.
"""
import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import backbone as tbb
from repro_torch.models.modality import synthetic_prefix
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(compute_dtype=torch.float32)
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel and the captured "
                    "decode step run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,hd", [
    (4, 32, 32, 64 + 2048, 64),      # musicgen-large prefill, MHA
    (2, 64, 8, 256 + 2048, 128),     # chameleon-34b prefill, GQA 8:1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_layouts_match_plain(cuda_device, B, H, KV, T, hd, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((B, T, H, hd), generator=gen, device=cuda_device)
    k, v = (torch.randn((B, T, KV, hd), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    route = fa_kernel.BF16_ROUTE if dtype == torch.bfloat16 \
        else fa_kernel.F32_ROUTE
    before = fa_kernel.route_launches[route]
    out = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_kernel.route_launches[route] == before + 1
    ref = fa_ops.flash_attention(q, k, v, backend="ref")
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _model(name, dev, **over):
    cfg = REDUCED[name].with_overrides(**over)
    params = tbb.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=dev)
    pe = (synthetic_prefix(gen, cfg, 2, device=dev)
          if cfg.prefix_frontend else None)
    return cfg, params, toks, pe


@pytest.mark.cuda
def test_prefix_prefill_kernel_path_holds_plain_path(cuda_device):
    """fp32 prefill of a reduced musicgen with its prefix through the
    3xTF32 flash kernel (one launch a layer) against the plain path: the
    logits and the whole cache (the prefix's entries included) within
    1e-4; the next position P + S."""
    cfg, params, toks, pe = _model("musicgen-large", cuda_device)
    kw = dict(cache_len=64, prefix_embeds=pe, cache_dtype=torch.float32,
              **F32)
    fa_kernel.reset_launches()
    lk, sk, nk = tbb.prefill(params, toks, cfg, use_kernels=True, **kw)
    assert fa_kernel.route_launches[fa_kernel.F32_ROUTE] == cfg.num_layers
    lp, sp, _ = tbb.prefill(params, toks, cfg, use_kernels=False, **kw)
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))
    assert nk.tolist() == [cfg.prefix_len + 40] * 2
    assert rel(lk, lp) <= TOL
    for k in ("k", "v"):
        assert rel(sk["cache"][k], sp["cache"][k]) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chameleon-34b", "deepseek-v3-671b"])
def test_decode_captures_bitwise_eager(cuda_device, name):
    """chameleon's qk-norm decode and deepseek's absorbed MLA decode on
    its latent cache: the captured step gives the eager step's logits and
    state bit for bit."""
    over = {"num_kv_heads": 2} if name == "chameleon-34b" else {}
    cfg, params, toks, pe = _model(name, cuda_device, **over)
    _, state, nxt = tbb.prefill(params, toks, cfg, cache_len=64,
                                prefix_embeds=pe, cache_dtype=torch.float32,
                                **F32)
    eager = tsteps.make_serve_step(cfg, device=cuda_device, **F32)
    captured = tsteps.make_captured_serve_step(cfg, device=cuda_device,
                                               **F32)
    s_e, s_c = (tree_map(torch.clone, state) for _ in range(2))
    tok, pos = toks[:, -1:], nxt
    for _ in range(4):
        le, _ = eager(params, s_e, tok, pos)
        lc, _ = captured(params, s_c, tok, pos)
        assert torch.equal(le, lc)
        tok, pos = le[:, 0].argmax(-1, keepdim=True), pos + 1
    assert captured.captures == 1 and captured.replays == 4
    for a, b in zip(tree_leaves(s_e), tree_leaves(s_c)):
        assert torch.equal(a, b)
