"""The moe family on the card (granite-moe-1b-a400m's reduced config with
the gspmd dispatch of the full one): the decode step captures as a CUDA
graph (the dispatch makes no host sync) and gives the eager step's logits
bit for bit, and the flash kernel's prefill path holds the plain path's.
These tests need a CUDA device and skip without one; the reference's
parity tests are in tests/test_torch_moe.py.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.launch import steps as tsteps
from repro_torch.models import backbone as tbb
from repro_torch.tree import tree_map

F32 = dict(compute_dtype=torch.float32)
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured decode step and the "
                    "flash kernel run only on the card")
    return torch.device("cuda")


def _granite_gspmd():
    cfg = REDUCED["granite-moe-1b-a400m"].with_overrides(num_kv_heads=2)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                      impl="gspmd"))


def _setup(dev):
    cfg = _granite_gspmd()
    params = tbb.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=gen,
                         device=dev)
    return cfg, params, toks


@pytest.mark.cuda
def test_gspmd_decode_captures_bitwise_eager(cuda_device):
    cfg, params, toks = _setup(cuda_device)
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


@pytest.mark.cuda
def test_prefill_kernel_path_holds_plain_path(cuda_device):
    """fp32 prefill through the 3xTF32 flash kernel (GQA 2:1) against the
    plain attention path: one launch a layer, logits within 1e-4."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    cfg, params, toks = _setup(cuda_device)
    kw = dict(cache_len=64, cache_dtype=torch.float32, **F32)
    fa_kernel.reset_launches()
    lk, _, _ = tbb.prefill(params, toks, cfg, use_kernels=True, **kw)
    assert fa_kernel.route_launches[fa_kernel.F32_ROUTE] == cfg.num_layers
    lp, _, _ = tbb.prefill(params, toks, cfg, use_kernels=False, **kw)
    gap = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    assert gap <= TOL, gap
