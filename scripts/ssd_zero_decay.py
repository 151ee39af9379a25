"""Does Mamba2's chunked SSD at zamba2-1.2b's full width meet chunk decays
that underflow to exactly 0, and what does the chunk recurrence make of
them? One card.

    python3 scripts/ssd_zero_decay.py

Runs the first Mamba2 block of zamba2-1.2b (d 2048, 64 SSD heads of 64,
state 64, chunk 128; its init from a seed) in fp32 on what the model's
first block sees: RMS-normed token embeddings of a B x S prompt (the
embedding's init, N(0, 0.02)). Twice, through ``layers.mamba2_forward``:

- ``log_zero_-inf``: the chunk recurrence with log 0 = -inf, as
  ``linear_recurrence_pscan`` took it before its repair (a block's
  weights exp(C_i - C_j) then meet -inf - -inf = NaN where a decay is 0);
- ``repaired``: as committed (log 0 = ``layers.LOG_ZERO``, -1e4).

Prints one JSON line each: the chunk decays a = exp(Σ dt·A) that are
exactly 0 in fp32 (counted where the recurrence receives them), the NaN
and inf elements of the block's output and final SSM state, and, for the
repaired run, the output's largest magnitude. The card's name and power
limit print first.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

B, S = 4, 2048


def run(p, x, cfg, log_zero: float) -> dict:
    seen = []
    real_prev, real_floor = L._prev_states, L.LOG_ZERO

    def counted(a, b, extra_dims=1):
        seen.append((int((a == 0).sum()), a.numel(),
                     int((a == 0).any(dim=(0, 1)).sum())))
        return real_prev(a, b, extra_dims)

    L._prev_states, L.LOG_ZERO = counted, log_zero
    try:
        with torch.no_grad():
            out, (_, state) = L.mamba2_forward(p, x, cfg, return_state=True)
        torch.cuda.synchronize()
    finally:
        L._prev_states, L.LOG_ZERO = real_prev, real_floor
    zeros, total, heads = seen[0]
    return {"log_zero": log_zero, "batch": B, "seq": S,
            "chunk_decays": total, "chunk_decays_exactly_0": zeros,
            "heads_with_a_0": heads, "heads": cfg.ssm.expand * cfg.d_model
                                              // cfg.ssm.head_dim,
            "out_nan": int(torch.isnan(out).sum()),
            "out_inf": int(torch.isinf(out).sum()),
            "state_nan": int(torch.isnan(state).sum()),
            "out_max_abs": float(torch.nan_to_num(out).abs().max())}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_zero_decay: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    cfg = ARCHS["zamba2-1.2b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.init_mamba2(gen, cfg, torch.float32, dev)
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) * 0.02
    x = L.apply_rmsnorm(L.init_rmsnorm(cfg.d_model, torch.float32, dev), emb,
                        cfg.norm_eps)
    for name, floor in (("log_zero_-inf", float("-inf")),
                        ("repaired", L.LOG_ZERO)):
        print(json.dumps({"run": name, **run(p, x, cfg, floor)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
