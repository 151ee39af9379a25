"""The hybrid family on the card (zamba2-1.2b's reduced config): the decode
step captures as a CUDA graph (the Mamba2 conv window is rebuilt in a
fresh tensor, and nothing syncs the host) and gives the eager step's
logits bit for bit; the flash kernel's prefill path at the MHA layout
(one K/V head per query head) holds the plain path's; a reused server
slot serves as a fresh server does. These tests need a CUDA device and
skip without one; the reference's parity tests are in
tests/test_torch_hybrid.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import backbone as tbb
from repro_torch.tree import tree_leaves, tree_map

F32 = dict(compute_dtype=torch.float32)
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured decode step and the "
                    "flash kernel run only on the card")
    return torch.device("cuda")


def _setup(dev, num_layers=3):
    cfg = REDUCED["zamba2-1.2b"].with_overrides(num_layers=num_layers)
    params = tbb.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=gen,
                         device=dev)
    return cfg, params, toks


@pytest.mark.cuda
@pytest.mark.parametrize("num_layers", [3, 4])
def test_hybrid_decode_captures_bitwise_eager(cuda_device, num_layers):
    cfg, params, toks = _setup(cuda_device, num_layers)
    _, state, nxt = tbb.prefill(params, toks, cfg, cache_len=64,
                                cache_dtype=torch.float32, **F32)
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


@pytest.mark.cuda
def test_prefill_kernel_path_holds_plain_path(cuda_device):
    """fp32 prefill through the 3xTF32 flash kernel at the MHA layout
    against the plain attention path: one launch per shared application,
    logits and the Mamba2 states within 1e-4."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    cfg, params, toks = _setup(cuda_device, 4)
    kw = dict(cache_len=64, cache_dtype=torch.float32, **F32)
    fa_kernel.reset_launches()
    lk, sk, _ = tbb.prefill(params, toks, cfg, use_kernels=True, **kw)
    assert fa_kernel.route_launches[fa_kernel.F32_ROUTE] == 2
    lp, sp, _ = tbb.prefill(params, toks, cfg, use_kernels=False, **kw)
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))
    assert rel(lk, lp) <= TOL
    assert rel(sk["mamba"]["ssm"], sp["mamba"]["ssm"]) <= TOL


@pytest.mark.cuda
def test_captured_server_reused_slot_serves_as_fresh(cuda_device):
    cfg, params, _ = _setup(cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(3, 9))
               for _ in range(4)]
    reqs = lambda: [tserve.Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(prompts)]
    reused = tserve.BatchedServer(cfg, params, slots=1, cache_len=16,
                                  device=cuda_device).serve(reqs())
    eager = tserve.BatchedServer(cfg, params, slots=1, cache_len=16,
                                 device=cuda_device, capture=False)
    assert dict(eager.serve(reqs())) == dict(reused)
    for r in reqs():
        fresh = tserve.BatchedServer(cfg, params, slots=1, cache_len=16,
                                     device=cuda_device)
        assert fresh.serve([r])[r.rid] == reused[r.rid], r.rid
