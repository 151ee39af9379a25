"""The captured decode step (``launch.steps.make_captured_serve_step``):
the port's counterpart of the reference's ``jax.jit`` of the serve step,
one CUDA graph per (params, state, batch) layout, and ``BatchedServer``
on it (its default on CUDA).

On the card, the captured step must equal the eager step over several
steps (the same kernels on the same inputs: 0 expected, bar 1e-6
relative) for a dense and an ssm config, in fp32 and bf16 compute; the
captured server must give the eager server's tokens, greedy and sampled,
with one graph per slot plus one for the full batch. On the CPU there is
no graph: asking for one raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (make_captured_serve_step,
                                      make_prefill_step, make_serve_step)
from repro_torch.models import backbone as tbb
from repro_torch.tree import tree_leaves, tree_map

CONFIGS = {"llama3.2-1b": REDUCED["llama3.2-1b"].with_overrides(
               num_kv_heads=2),
           "rwkv6-3b": REDUCED["rwkv6-3b"]}
BAR = 1e-6
STEPS = 8


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / max(torch.linalg.norm(b), 1e-30))


def test_captured_step_needs_a_card():
    cfg = CONFIGS["llama3.2-1b"]
    with pytest.raises(ValueError, match="CUDA device"):
        make_captured_serve_step(cfg, device="cpu")
    params = tbb.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tserve.BatchedServer(cfg, params, device="cpu", capture=True)
    assert tserve.BatchedServer(cfg, params, device="cpu").captures == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: decode steps are captured in CUDA "
                    "graphs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(cfg, dev, seed=0):
    return tbb.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_captured_decode_equals_eager_on_cuda(cuda_device, arch, dtype):
    cfg = CONFIGS[arch]
    params = _params(cfg, cuda_device)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12 + STEPS)), device=cuda_device)
    prefill = make_prefill_step(cfg, cache_len=32, compute_dtype=dtype,
                                cache_dtype=dtype, device=cuda_device)
    _, state, pos = prefill(params, {"tokens": tok[:, :12]})
    s_eager = tree_map(torch.clone, state)
    eager = make_serve_step(cfg, compute_dtype=dtype, device=cuda_device)
    captured = make_captured_serve_step(cfg, compute_dtype=dtype,
                                        device=cuda_device)
    worst = 0.0
    for t in range(STEPS):
        le, _ = eager(params, s_eager, tok[:, 12 + t:13 + t], pos + t)
        lc, out = captured(params, state, tok[:, 12 + t:13 + t], pos + t)
        assert out is state
        worst = max(worst, _rel(lc, le))
    torch.cuda.synchronize()
    print(f"parity-gap captured vs eager decode {arch} {dtype}: "
          f"{worst:.2e} (bar {BAR:.0e})")
    assert worst <= BAR
    for a, b in zip(tree_leaves(state), tree_leaves(s_eager)):
        assert _rel(a.float(), b.float()) <= BAR
    assert (captured.captures, captured.replays) == (1, STEPS)


@pytest.mark.cuda
def test_captured_step_follows_params_and_state_on_cuda(cuda_device):
    """A graph is keyed by where params and state lie: other params (or a
    per-slot view) get a graph of their own and their own answer."""
    cfg = CONFIGS["rwkv6-3b"]
    dev = cuda_device
    captured = make_captured_serve_step(cfg, compute_dtype=torch.float32,
                                        device=dev)
    eager = make_serve_step(cfg, compute_dtype=torch.float32, device=dev)
    tok = np.array([[3], [5]], np.int32)
    pos = np.zeros((2,), np.int32)
    alive = []              # freed tensors could hand their addresses on
    for seed in (0, 1):
        params = _params(cfg, dev, seed)
        state = tbb.init_decode_state(cfg, 2, 8, device=dev)
        alive.append((params, state))
        want, _ = eager(params, tbb.init_decode_state(cfg, 2, 8, device=dev),
                        tok, pos)
        got, _ = captured(params, state, tok, pos)
        assert _rel(got, want) <= BAR
        sub = tree_map(lambda a: a[:, 1:2], state)      # a view of row 1
        want1, _ = eager(params, tree_map(torch.clone, sub), tok[1:],
                         pos[1:])
        got1, _ = captured(params, sub, tok[1:], pos[1:])
        assert _rel(got1, want1) <= BAR
    assert captured.captures == 4


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_captured_server_equals_eager_server_on_cuda(cuda_device, arch,
                                                     temperature):
    cfg = CONFIGS[arch]
    params = _params(cfg, cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
               for _ in range(7)]
    prompts[3] = np.array([], np.int64)

    def server(capture):
        return tserve.BatchedServer(cfg, params, slots=3, cache_len=16,
                                    temperature=temperature, seed=5,
                                    device=cuda_device, capture=capture)

    def requests(n, max_new=None):
        return [tserve.Request(rid=i, prompt=p,
                               max_new=max_new or 4 + 3 * (i % 2))
                for i, p in enumerate(prompts[:n])]

    eager, captured = server(False), server(None)   # None: CUDA's default
    out_e = eager.serve(requests(7))
    out_c = captured.serve(requests(7))
    assert eager.captures == 0
    assert captured.captures == captured.slots + 1
    assert dict(out_c) == dict(out_e)
    assert out_c.status == out_e.status
    assert set(out_c.status.values()) == {"done"}
    # a second queue on the same server replays and captures nothing, and
    # answers as a fresh server does
    again = captured.serve(requests(4, max_new=3))
    assert captured.captures == captured.slots + 1
    assert dict(again) == dict(server(False).serve(requests(4, max_new=3)))
