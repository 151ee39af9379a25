"""Drive the PyTorch/CUDA port of FedDCL on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (nvcc, at
first use, one process per source in parallel) and holds each against its
plain PyTorch version at the shapes its path gives it. Then it drives
these paths through the port's public entry points:

- FedDCL Algorithm 1 end to end at the width of the paper's mnist model
  (784 -> m̃ = m̂ = 50, MLP 50-500-100-10; Experiment II layout d = 5 groups
  x c = 4 users x 100 samples, 2000 anchor rows, 20 rounds x 4 local
  epochs, batch 32) with FedDCL's defaults: the Gram kernel's path, and
  step 4 on the scan engine through the plan cache, one CUDA-graph replay
  a round (its first call split into build, warm-up, capture and
  replays; a second tenant in the same bucket, which captures nothing).
  The same fit on the host engine beside it, and the two engines held
  together on the card. Then step 5 as a live service: FedDCL.serve()
  (one captured CUDA graph per shape bucket) under a 1,024-request
  mixed-tenant stream, cold and warm, and live onboarding of a silo (the
  Gram kernel's onboarding launches) and of a user, every served row held
  to its direct path;
- the paper's experiments through the port's experiment scripts
  (``repro_torch.benchmarks``, ``repro_torch.experiments``): Experiment I
  at its full layout and Experiment II's mnist column at the paper's
  width, all five methods on the scan engine with FedDCL's step 3 on the
  device backend (the Gram kernel), each with the reference's claims; the
  host-vs-device scenario matrix; the communication count; the plan-cache
  sweeps with their asserts; and the kernel micro-benchmarks, with the
  batched Gram at least 3x a loop of single calls;
- the reference's scripts that carry bars, through the port's
  (``serve_bench`` at its full layout, ``robust_ablation`` at its full
  sizes, ``fed_bench --fast``, and the examples ``end_to_end_driver``,
  ``feddcl_llm_pretrain`` and ``serve_batched``), each with its own bars:
  a warm serve sweep that builds and captures nothing, every group's
  captured serve step answering from its arguments, onboarding against a
  recompute, the robust aggregators' acceptance, host == scan on the card,
  and the federated LLM losses falling;
- the analysis tier (``repro_torch.analysis``): the artifact audit's
  matrix (a tiny FL plan lowered in every unsharded flavor, captured,
  replayed and held to its eager rounds, with no tenant data in it), its
  two positive controls caught and its warm run building nothing; then
  FedDCL's fit and serve() through the default plan cache, after which
  every idle cached plan must hold only splats (the buffers a run filled
  are zeroed), a reused FL plan gives its first tenant bitwise its own
  answer again, and the clears are timed per FL run and per serve step;
  the audit's sharded flavors run on 2 ranks on the card;
- FedDCL's step 4 across DC-server processes: steps 1–3 of the mnist-width
  fit here, then 2 ranks (processes, both on the card, 4 of the 8
  bucketed silos each, the collectives over gloo through pinned host
  memory) run the federated phase with a mesh: held to the unsharded scan
  engine (fedavg's params after 1 round and the median's, under dropout
  with a scaled silo, after 2 within 1e-5, every round's loss within
  1e-5; fedavg's params after 2 and 20 rounds beside a 1e-7 nudge of the
  init; fed_bench's d 8 x 20-round row within the 1e-2 sanity bound),
  every rank's params bitwise alike, the round's collective census, and
  a round, its collective and the unsharded round timed;
- the LLM serving path at full width and depth with random weights from a
  seed: llama3.2-1b prefill (bf16, B=4 x 2048 tokens) -> 32 decode steps ->
  BatchedServer (decode and server eager and as captured CUDA graphs,
  the captured ones held to the eager ones), and gemma2-2b prefill (bf16
  and fp32, 8192 tokens, past its 4096-token window): the
  flash-attention kernels' path (bf16: the
  wgmma/TMA kernel; fp32: the 3xTF32 mma.sync kernel), held against the
  plain attention path of the same model;
- the rwkv6-3b training path at full width and depth with random weights
  from a seed, under TrainConfig's defaults (params fp32, compute bf16,
  AdamW fp32, remat on): TokenStream batches of 2 x 1024 tokens through
  make_train_step for a few steps: the WKV6 kernels' path (the chunked
  forward, twice a layer under remat, and its gradient kernel, once a
  layer), its loss held against the plain WKV6 path of the same model in
  fp32; then rwkv6-3b served on the trained params: a bf16 prefill (the
  chunked plain form, no WKV6 launch), decode and BatchedServer eager and
  captured, and prefill + decode held to forward in fp32; then FedDCL's
  federated training on those params: 2 silos x 2 local steps a round at
  full width (bf16 AdamW moments, so two silos fit), one round step by
  step, two through make_federated_round_step and two in one
  make_federated_multiround_step call, the silos compared before and
  after each sync and the fedavg / median / Krum syncs timed alone; and
  the reduced train() CLI on the card, dense (plain attention) and
  federated with a checkpoint read back;
- the moe family at full width and depth with random weights from a seed:
  granite-moe-1b-a400m (24 layers, 32 experts top-8, the gspmd capacity
  dispatch) prefilled in bf16 and fp32 (B=4 x 2048, the flash kernels'
  path, 24 launches of each route, held against the plain path, every
  routing decision that differs between two paths counted with its top-k
  margin), 32 bf16 decode steps eager and captured (the same tokens,
  bitwise the same logits), BatchedServer eager and captured, 5 train
  steps under TrainConfig's defaults on plain attention, and FedDCL's
  federated round (2 silos x 2 local steps, fedavg, 3 rounds, the silos
  equal after each sync);
- the hybrid family at full width and depth with random weights from a
  seed: zamba2-1.2b (38 Mamba2 blocks, the weight-shared attention +
  SwiGLU block after every 6th, MHA 32/32 heads) prefilled in bf16 and
  fp32 (B=4 x 2048, 6 launches of each flash route at the MHA layout,
  held against the plain path; the SSD scans' share of the bf16
  prefill's device time by CUDA events), fp32 prefill(2047) + one decode
  held to the forward, 32 bf16 decode steps eager and captured,
  BatchedServer eager and captured with a reused slot against fresh
  servers, 5 train steps under TrainConfig's defaults on plain
  attention, and 3 fedavg rounds of 2 silos x 2 local steps;
- the modality-prefix families and MLA, random weights from a seed:
  musicgen-large at full width and depth (48 layers, MHA 32/32 heads of
  64, a synthetic prefix of 64 frames) prefilled in bf16 and fp32 (B=4 x
  2048 after the prefix, T = 2112: the flash kernels' ragged last key
  tile, 48 launches of each route, held against the plain path on the
  logits and the whole cache), fp32 prefill(S - 1) + decode held to the
  forward, 32 bf16 decode steps eager and captured, BatchedServer eager
  and captured, 5 train steps of 2 x 1024 after the prefix on plain
  attention and 3 fedavg rounds of 2 silos x 2 local steps with bf16
  moments; chameleon-34b at full width with qk-norm, its depth cut to 8
  of 48 layers (GQA 64/8 at hd 128, a prefix of 256 patches; bf16 and
  fp32 prefills of 2 x 2048, the handoff, a decode eager and captured);
  deepseek-v3 at full width cut to 2 layers and 32 of 256 experts (MLA:
  a bf16 prefill into the latent cache, decode on it eager and captured,
  the absorbed decode held to the expanded forward in fp32, 3 train
  steps with MTP and bf16 moments);
- the launch tier's dry-run (``repro_torch.launch.dryrun``): the
  llama3.2-1b bf16 prefill (4 x 2048, plain path) and a granite-moe-1b
  train step (4 x 2048) traced on fake CUDA tensors, then run for real
  from a reset peak: the fake and real flop counts equal, the trace's
  peak within 0.8-1.25 of the allocator's; the dry-run's CLI for a
  traced and a spec-level pair;
- the expert-parallel MoE exchange (``repro_torch.models.moe_ep``): one
  granite-moe-1b MoE layer at full width (E 32, top-8, d 1024) on 2
  ranks sharing the card, one all_to_all each way over gloo through
  pinned host memory, forward and backward of 2 x 2048 tokens in fp32,
  held to the plain one-process emulation of the exchange within 1e-5,
  with its bytes and ms a layer;
- the sharded LLM program (``repro_torch.launch.llm_ranks``): first a
  probe of which collectives a plain gloo group takes for CUDA tensors
  (2 ranks); then 4 ranks sharing the card on a (2, 2) ("data",
  "model") mesh over the staged backend (``launch.staged``): llama3.2-1b
  at full width and depth with its params laid out by ``param_specs``
  as DTensors, an fp32 loss and gradient of 2 x 512 tokens held to the
  unsharded computation on the card (loss 1e-5, gradients 1e-4 over
  max(1, |g|)), 3 bf16 train steps of 4 x 2048 timed (step s by rank,
  the staged collectives' calls, ms and bytes a step, peak memory a
  rank), and granite-moe-1b's expert-parallel MoE layer with its FSDP
  gather over "data" held to the per-block emulation (1e-5) with its ms
  a layer.

Each phase prints one JSON line. Host-bound rows (step 4's rounds, decode,
the server, the train step, the federated rounds) give min / median / max
over repeats. The line
before the last lists every kernel with its launches on the main path,
error and times; the last line is {"ok": true, "device": {...}}. Any failure exits non-zero before it.
Without CUDA, or without the rest of the repository beside it, the script
fails and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# flex_attention, the softcap rows' yardstick, is compiled by Inductor and
# Triton: their caches go beside the kernels' build, and the compile runs in
# this process (no worker pool left behind)
_CACHE = ROOT / "src" / "repro_torch" / "kernels" / "build" / "compile_cache"
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(_CACHE / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import audit, find_baked_constants  # noqa: E402
from repro_torch.api import FedDCL  # noqa: E402
from repro_torch.benchmarks import (comm_cost, exp1_convergence,  # noqa: E402
                                    exp3_groups, fed_bench, kernels_bench,
                                    serve_bench)
from repro_torch.benchmarks.common import run_all_methods  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import (ARCHS, REDUCED,  # noqa: E402
                                 FederatedConfig, InputShape, TrainConfig)
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.federated import (FLPlan, PlanCache,  # noqa: E402
                                        clear_plan_cache, default_plan_cache,
                                        padded_layout, plan_cache_stats,
                                        round_perms, run_federated,
                                        silo_replicate)
from repro_torch.data.partition import split_iid  # noqa: E402
from repro_torch.data.tokens import TokenStream, silo_batches  # noqa: E402
from repro_torch.data.tabular import make_dataset, train_test_split  # noqa: E402
from repro_torch.examples import (end_to_end_driver,  # noqa: E402
                                  feddcl_llm_pretrain, serve_batched)
from repro_torch.experiments import robust_ablation, sweep  # noqa: E402
from repro_torch.graphs import capture  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gram import kernel as gram_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.launch import dryrun, fed_ranks, llm_ranks  # noqa: E402
from repro_torch.launch import roofline, roofline_table  # noqa: E402
from repro_torch.launch.mesh import RankError, run_ranks  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.launch.steps import (make_captured_serve_step,  # noqa: E402
                                      make_fedavg_sync_step,
                                      make_federated_local_phase_step,
                                      make_federated_local_step,
                                      make_federated_multiround_step,
                                      make_federated_round_step,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, silo_opt_init)
from repro_torch.launch.train import step_prefix, train  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import mlp, moe_ep  # noqa: E402
from repro_torch.models.modality import synthetic_prefix  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve_collab.server import (  # noqa: E402
    serve_step as collab_serve_step)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import mlp_params_to_numpy  # noqa: E402

# Published dense peaks of the H100 SXM (NVIDIA data sheet): fp32 FFMA
# outside the tensor cores, TF32 and bf16 on the tensor cores, and
# device-memory bandwidth, in units per second.
H100_SXM = {"fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
            "bytes": 3.35e12}

# the Experiment II layout at the width of the paper's mnist model
D, C, N_IJ, M_TILDE, ANCHOR_R = 5, 4, 100, 50, 2000
FIT_LAUNCHES = 2 + D     # groups' batched Gram, central Gram, D onboarding Grams
MAIN_SHAPES = [(D, ANCHOR_R, C * M_TILDE), (1, ANCHOR_R, D * M_TILDE),
               (1, ANCHOR_R, C * M_TILDE)]
MAIN_COUNTS = [1, 1, D]  # launches of each shape in one fit
EXTRA_SHAPES = [(3, 1037, 77),            # ragged edges in r and m
                (2, 17, 1),               # almost no work: a call's fixed cost
                (16, 8192, 1024)]         # a large deployment: 512 MiB in
GRAM_TOL = 1e-5          # kernel (3xTF32) vs plain (fp32 FFMA), relative Frobenius
DEVICE_HOST_TOL = 1e-3   # the reference's device-vs-host bar
ONBOARD_TOL = 1e-5       # incremental == recompute on device

# flash attention: (name, B, H, KV, Sq, Sk, hd, window, softcap, q_offset)
LLAMA = ARCHS["llama3.2-1b"]
GEMMA = ARCHS["gemma2-2b"]
FLASH_SHAPES = [
    ("llama3.2-1b prefill", 4, 32, 8, 2048, 2048, 64, 0, 0.0, 0),
    ("granite-moe-1b prefill", 4, 16, 8, 2048, 2048, 64, 0, 0.0, 0),
    ("zamba2-1.2b prefill", 4, 32, 32, 2048, 2048, 64, 0, 0.0, 0),
    # the prefix families: T = P + S, the prefix on the key axis too
    ("musicgen-large prefill", 4, 32, 32, 2112, 2112, 64, 0, 0.0, 0),
    ("chameleon-34b prefill", 2, 64, 8, 2304, 2304, 128, 0, 0.0, 0),
    ("gemma2-2b local layer", 1, 8, 4, 8192, 8192, 256, 4096, 50.0, 0),
    ("gemma2-2b global layer", 1, 8, 4, 8192, 8192, 256, 0, 50.0, 0),
    ("q tail at q_offset", 4, 32, 8, 256, 2048, 64, 0, 0.0, 1792),
    ("ragged", 2, 4, 2, 1000, 1000, 64, 0, 0.0, 0),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py:31
LM_TOL = 1e-4            # kernel path vs plain path logits, relative, fp32
BF16_GAP = 2.0           # bf16 kernel path's gap to the fp32 plain path, as
                         # a multiple of the bf16 plain path's own gap
PREFILL_B, PREFILL_S, PREFILL_CACHE = 4, 2048, 4096
DECODE_STEPS = 32
REPEATS = 3              # decode and server runs, each timed (min / median / max)
GEMMA_S = 8192           # > the 4096-token window: local layers mask

# WKV6: (name, B, S, H, K, V); the first is rwkv6-3b's train shape
RWKV = ARCHS["rwkv6-3b"]
WKV_SHAPES = [("rwkv6-3b train", 2, 1024, 40, 64, 64),
              ("ragged K", 1, 96, 3, 24, 40)]
WKV_ATOL, WKV_RTOL = 2e-4, 2e-3   # tests/test_kernels.py, wkv6 cases
WKV_GRAD_TOL = 1e-5      # gradient kernel vs plain gradients, relative, each
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 5
GRAD_LAYERS = 2          # depth of the full-width model-level gradient check

# step 5 as a live service (serve_collab): the request stream of the
# reference's CLI (src/repro/launch/serve_collab.py) at the mnist width
SERVE_REQUESTS, SERVE_MAX_ROWS, SERVE_MAX_BATCH = 1024, 48, 256
NEWCOMER_REQUESTS = 64   # served through each onboarded tenant
# served vs direct path: the reference's atol 2e-5 (tests/test_serve_collab.py:50,
# outputs of order 1 there), on the error scaled by max(1, max |direct|): the
# mnist-width logits reach ~37, where 2e-5 is ~5 fp32 ulps and the fp32 direct
# path alone lies 1.3e-5 from its float64 value (PERF.md §6)
SERVE_TOL = 2e-5
# rwkv6-3b serving: a bf16 prefill, then decode and BatchedServer as llama's
RWKV_PREFILL_B, RWKV_PREFILL_S = 4, 1024
RWKV_CHECK_S = 1024      # fp32 prefill(S-1) + decode vs forward, B = 1
GRAPH_TOL = 1e-6         # captured vs eager decode logits, relative
# FedDCL's federated round on rwkv6-3b at full width and depth: FED_D silos
# x FED_H local steps of FED_B x TRAIN_S tokens a silo (the WKV6 kernels'
# train shape). AdamW's moments in bf16, TrainConfig's setting for large
# models: with fp32 moments two silos do not fit one card beside one
# silo's gradients
FED_D, FED_H, FED_B = 2, 2, 2
FED_ROUND_STEPS, FED_R = 2, 2   # rounds through round_step, then multi_step's R
FED_SAMPLE = 1 << 20     # elements of each sampled leaf held to the float64 mean
FED_MEAN_TOL = 1e-6      # fedavg vs the float64 mean of the silos, relative
FED_SYNCS = ("fedavg", "median", "krum")
# granite-moe-1b-a400m (the moe family) at full width and depth: bf16 and
# fp32 prefills of GRANITE_B x GRANITE_S (the second FLASH_SHAPES row), a
# bf16 decode from the first, BatchedServer, TrainConfig's train steps and
# a federated round on GRANITE_B x GRANITE_S tokens (split over the silos)
GRANITE = ARCHS["granite-moe-1b-a400m"]
GRANITE_B, GRANITE_S, GRANITE_CACHE = 4, 2048, 4096
GRANITE_FED_ROUNDS = 3
# zamba2-1.2b (the hybrid family) at full width and depth: bf16 and fp32
# prefills of ZAMBA_B x ZAMBA_S (the zamba2 FLASH_SHAPES row: MHA, one K/V
# head a query head), the fp32 prefill(S - 1) + decode handoff at B = 1, a
# bf16 decode from the bf16 prefill, BatchedServer (and a reused slot
# against fresh servers), TrainConfig's train steps and federated rounds
ZAMBA = ARCHS["zamba2-1.2b"]
ZAMBA_B, ZAMBA_S, ZAMBA_CACHE = 4, 2048, 4096
ZAMBA_FED_ROUNDS = 3
ZAMBA_REUSE_REQUESTS = 3  # served in turn through one slot, and each alone
# musicgen-large (the audio family) at full width and depth, its EnCodec
# frames a synthetic prefix of P = 64: bf16 and fp32 prefills of
# MUSICGEN_B x MUSICGEN_S tokens after the prefix (the musicgen
# FLASH_SHAPES row, T = 2112), the fp32 prefill(S - 1) + decode handoff at
# B = 1, a bf16 decode, BatchedServer, TrainConfig's train steps on
# MUSICGEN_TRAIN_B x MUSICGEN_TRAIN_S and federated rounds on
# MUSICGEN_FED_B x MUSICGEN_TRAIN_S with bf16 moments (with fp32 ones two
# silos of 3.2B do not fit beside one silo's gradients). A cache holds the
# prefix, the prompt and the decode steps of the phase
MUSICGEN = ARCHS["musicgen-large"]
MUSICGEN_B, MUSICGEN_S = 4, 2048
MUSICGEN_TRAIN_B, MUSICGEN_TRAIN_S, MUSICGEN_FED_B = 2, 1024, 4
MUSICGEN_FED_ROUNDS = 3
DECODE_ROOM = 256        # cache slots past the prompt: every decode step run
# chameleon-34b (the vlm family, qk-norm) at full width, depth cut to 8 of
# 48 layers (6.6B parameters; all 48 do not fit one card beside anything),
# its VQ patches a synthetic prefix of P = 256: bf16 and fp32 prefills of
# CHAMELEON_B x CHAMELEON_S (the chameleon FLASH_SHAPES row, GQA 8:1 at
# hd 128, T = 2304), the fp32 handoff and a bf16 decode; no train leg
# (fp32 params and moments of 6.6B exceed the card)
CHAMELEON = ARCHS["chameleon-34b"].with_overrides(num_layers=8)
CHAMELEON_B, CHAMELEON_S = 2, 2048
# deepseek-v3 (MLA, the moe family) at full width, cut to 2 layers (1
# dense + 1 MoE) and 32 of 256 experts, top-8 kept: a bf16 prefill of
# DEEPSEEK_B x DEEPSEEK_S, a bf16 decode on the latent cache, the fp32
# handoff (absorbed decode vs the expanded forward) and TrainConfig's
# train steps with MTP, bf16 moments (a cut: fp32 ones do not fit beside
# fp32 params and gradients of 4.8B)
DEEPSEEK = ARCHS["deepseek-v3-671b"].with_overrides(
    num_layers=2, first_k_dense=1,
    moe=replace(ARCHS["deepseek-v3-671b"].moe, num_experts=32))
DEEPSEEK_B, DEEPSEEK_S = 2, 2048
DEEPSEEK_TRAIN_B, DEEPSEEK_TRAIN_S, DEEPSEEK_TRAIN_STEPS = 1, 1024, 3
# a routing flip (a token's chosen experts differ between two paths) in
# the first layer that has one, where the two paths' inputs differ by
# rounding only, is explained when the plain path's top-k margin there is
# below this (fp32 paths; relative gaps of ~1e-6 move the probabilities
# by far less)
FLIP_MARGIN = 1e-5
# the dry-run's one-card counters held to two runs the card makes: the
# llama3.2-1b bf16 prefill of PREFILL_B x PREFILL_S on the plain path and a
# granite-moe-1b train step of GRANITE_B x GRANITE_S (TrainConfig's
# defaults, plain attention); the fake trace's peak over the allocator's
# measured one must lie in DRYRUN_PEAK
DRYRUN_PEAK = (0.8, 1.25)
# the expert-parallel exchange: one granite-moe-1b MoE layer at full width
# (E 32, top-8, d 1024) on EP_RANKS ranks sharing the card, a (1, EP_RANKS)
# mesh, EP_B x EP_S tokens, fp32, forward and backward, held to the plain
# one-process emulation of the exchange
EP_RANKS, EP_B, EP_S, EP_AUX = 2, 2, 2048, 0.01
EP_TOL = 1e-5            # over max(1, |emulation|), each output and gradient
EP_REPEATS = 3           # warm forward + backward passes before the timed one
# the sharded LLM program: SLLM_RANKS ranks on the card, a SLLM_MESH
# ("data", "model") mesh; llama3.2-1b's fp32 check at SLLM_CHECK tokens,
# SLLM_STEPS bf16 train steps at SLLM_TRAIN tokens; granite's EP layer at
# SLLM_EP tokens, SLLM_EP_REPEATS forward passes
SLLM_RANKS, SLLM_MESH = 4, (2, 2)
SLLM_CHECK, SLLM_TRAIN, SLLM_STEPS = (2, 512), (4, 2048), 3
SLLM_EP, SLLM_EP_REPEATS = (4, 2048), 3
SLLM_LOSS_TOL, SLLM_GRAD_TOL = 1e-5, 1e-4
# the checked fp32 train step: a first update that shows (lr 1e-3 at once),
# params after it within 1e-4 relative Frobenius of the unsharded step's
SLLM_CHECK_TC = {"learning_rate": 1e-3, "warmup_steps": 1}
SLLM_STEP_TOL = 1e-4
# steps of the new decode rows' profiled runs and captured-vs-eager gap: the
# profiler's post-processing grows with the kernels it saw (rwkv6-3b runs
# ~2,800 a step)
PROFILE_STEPS = GAP_STEPS = 8


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase row also gets the run's elapsed
    seconds when it ends."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def spread(xs) -> dict:
    """min / median / max of repeated measurements, and how many."""
    xs = [float(x) for x in xs]
    return {"min": min(xs), "median": statistics.median(xs),
            "max": max(xs), "n": len(xs)}


def peaks_for(smi: str):
    """The peaks of the card `nvidia-smi` names; only the H100 SXM (sold as
    "H100 80GB HBM3") is known, and any other card fails the run."""
    name = smi.split(",")[0]
    check("H100" in name and "HBM3" in name,
          f"no published peaks for {name!r}: the bounds assume an H100 SXM")
    return H100_SXM


def time_ms(fn, reps: int) -> float:
    """Median per-call device time over `reps` calls, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def graph_ms(fn, calls: int, reps: int = 7) -> float:
    """Median device time per call of fn(), `calls` calls captured in one
    CUDA graph and replayed: the card's time for the work alone, with no
    host launch cost between calls (where a call is shorter than its host
    launch, `time_ms` times the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / calls)
    del graph
    return statistics.median(out)


def host_call_us(fn, calls: int) -> float:
    """Host time per call of fn(), `calls` calls issued back to back (the
    device syncs only before and after): what a call costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def profile_device(fn):
    """Run fn() once under torch.profiler: (host wall s, device s per
    kernel name, kernels run, runs per kernel name). Only the device-side
    events are summed: a CPU op's self device time repeats that of the
    kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, runs, kernels = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        per_kernel[e.key] = (per_kernel.get(e.key, 0.0)
                             + e.self_device_time_total / 1e6)
        runs[e.key] = runs.get(e.key, 0) + e.count
        if not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
    check(sum(per_kernel.values()) > 0, "the profiler saw no device time")
    return wall, per_kernel, kernels, runs


# -- phase 1 ---------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    sources = [gram_kernel.SOURCE, fa_kernel.SOURCE, fa_kernel.WGMMA_SOURCE,
               wkv_kernel.SOURCE, wkv_kernel.BWD_SOURCE]
    build.load_libraries(sources)
    build_s = time.perf_counter() - t0
    ptxas = {src.name: [l.strip() for l in
                        build.build_log.get(src.name, "").splitlines()
                        if "registers" in l or "spill" in l or "Compiling" in l
                        or "Performance Loss" in l]
             for src in sources}
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "nvcc_s": {src.name: build.build_seconds.get(src.name)
                     for src in sources},
          "ptxas": ptxas})
    return smi


# -- phase 2 ---------------------------------------------------------------

def gram_bounds(peak, b, r, m):
    """The least time for fp32-accurate AᵀA: the output is symmetric, so
    one triangle and the diagonal, B·r·m·(m+1) flops, is all the function
    needs, done as FFMA or as three TF32 products on the tensor cores,
    whichever is faster; a read once and the output written once.
    Returns (bound ms, bound_by, the FFMA-only bound ms)."""
    flops = 1.0 * b * r * m * (m + 1)
    t_bytes = 4.0 * (b * r * m + b * m * m) / peak["bytes"] * 1e3
    t_ffma = flops / peak["fp32_flops"] * 1e3
    t_tf32 = 3.0 * flops / peak["tf32_flops"] * 1e3
    t_ops = min(t_ffma, t_tf32)
    by = ("bytes" if t_bytes >= t_ops
          else "3xtf32" if t_tf32 <= t_ffma else "ffma")
    return max(t_ops, t_bytes), by, max(t_ffma, t_bytes)


def phase_kernel_check(peak):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in MAIN_SHAPES + EXTRA_SHAPES:
        b, r, m = shape
        a = torch.randn(shape, generator=gen, device=dev)
        g = gram_ops.gram_batched(a)
        g_again = gram_ops.gram_batched(a)
        g_ref = gram_ops.gram_batched(a, backend="ref")
        torch.cuda.synchronize()
        err = float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref))
        max_abs = float((g - g_ref).abs().max())
        symmetric = torch.equal(g, g.mT)
        repeatable = torch.equal(g, g_again)
        # per call between CUDA events, as every kernel row is timed (`ms`,
        # `plain_ms`, `library_ms`): what the fit's eager calls see, the
        # host's launch included where it is longer than the kernel; the
        # card's time alone from graph replays (`device_ms`, ...); and the
        # host's time per call (`host_us`, ...)
        big = r * m * b > 1e8
        kernel = lambda: gram_ops.gram_batched(a)
        plain = lambda: gram_ops.gram_batched(a, backend="ref")
        library = lambda: torch.bmm(a.mT, a)
        reps, calls = (5, 3) if big else (50, 50)
        ms, plain_ms, library_ms = (time_ms(f, reps)
                                    for f in (kernel, plain, library))
        device_ms, plain_device_ms, library_device_ms = (
            graph_ms(f, calls) for f in (kernel, plain, library))
        host_us, library_host_us = (host_call_us(f, calls)
                                    for f in (kernel, library))
        flops = 1.0 * b * r * m * (m + 1)
        bound_ms, bound_by, ffma_bound_ms = gram_bounds(peak, b, r, m)
        p = gram_kernel.plan(b, r, m, gram_kernel._sm_count(a.get_device()))
        row = {"phase": "kernel_check", "shape": list(shape),
               "rel_frobenius": err, "max_abs_err": max_abs,
               "symmetric": symmetric, "repeatable": repeatable, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "device_ms": device_ms, "plain_device_ms": plain_device_ms,
               "library_device_ms": library_device_ms,
               "host_us": host_us, "library_host_us": library_host_us,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ffma_bound_ms": ffma_bound_ms,
               "device_share_of_bound": bound_ms / device_ms,
               "split": p.split, "blocks": p.blocks,
               "device_gflops_per_s": flops / device_ms / 1e6}
        emit(row)
        rows.append(row)
        check(err <= GRAM_TOL, f"gram kernel vs plain at {shape}: {err}")
        check(symmetric, f"gram kernel output not exactly symmetric at {shape}")
        check(repeatable, f"gram kernel not bitwise repeatable at {shape}")
        del a, g, g_again, g_ref
    torch.cuda.empty_cache()
    return rows


# -- phase 3 ---------------------------------------------------------------

def mnist_exp2_layout(seed: int = 0):
    """The mnist stand-in at the paper's Experiment II layout, drawn as the
    reference's benchmarks/common.py draws it."""
    n_train = D * C * N_IJ
    ds = make_dataset("mnist", n=n_train + 1000 + 200, seed=seed)
    (Xtr, Ytr), (Xte, Yte) = train_test_split(ds, n_train, 1000, seed=seed)
    Xs, Ys = split_iid(Xtr, Ytr, D, [C] * D, N_IJ, seed=seed)
    return Xs, Ys, Xte, Yte


FIT_ROUNDS = 20
# rounds of each engine (cache off, one injected schedule) in scan_vs_host.
# From round 3 on, AdamW amplifies fp32 rounding where |g| nears its eps
# (the mnist-width loss falls below 0.04): after 4 rounds the host engine
# on the card and on the CPU part by 2e-3, as the two engines on the card
# do, while after 2 they stay within 5e-6 (scripts/fed_engine_gap.py)
SCAN_VS_HOST_ROUNDS = 2
ENGINE_TOL = 1e-4         # scan vs host, relative: the reference's engine bar


def fit_model(dev, **kw):
    """FedDCL at the mnist-width Experiment II configuration, with its
    defaults (scan engine, plan cache) unless `kw` says otherwise."""
    return FedDCL(m_tilde=M_TILDE, hidden=(500, 100), task="classification",
                  rounds=FIT_ROUNDS, local_epochs=4, batch_size=32,
                  anchor_r=ANCHOR_R, svd_backend="device", device=dev, **kw)


def fit_layout(model):
    return {"d": D, "c": C, "n_ij": N_IJ, "m": 784, "m_tilde": M_TILDE,
            "anchor_r": ANCHOR_R, "mlp": [M_TILDE, 500, 100, 10],
            "rounds": model.rounds, "local_epochs": model.local_epochs,
            "batch_size": model.batch_size}


def phase_fit(dev):
    """The main path: FedDCL.fit with its defaults. Step 4 runs on the scan
    engine through the process-wide plan cache: the first fit builds the
    plan and captures one round in a CUDA graph, then replays it a round."""
    t0 = time.perf_counter()
    Xs, Ys, Xte, Yte = mnist_exp2_layout()
    data_s = time.perf_counter() - t0
    clear_plan_cache()
    model = fit_model(dev)
    check(model.engine == "scan" and model.cache is True,
          "FedDCL's defaults are not the scan engine with the plan cache")
    gram_kernel.reset_launches()
    setup, res = model.fit(Xs, Ys)
    launches = gram_kernel.launches
    acc = model.score(Xte, Yte)
    # step 5: every user's integrated model t(X) = h(f(X) G); user (0,0)'s
    # must answer as the estimator's predict does
    h = lambda Z: mlp.mlp_forward(
        model.params_, torch.as_tensor(np.asarray(Z, np.float32), device=dev))
    with torch.no_grad():
        models = protocol.finalize_user_models(setup, h)
        t00 = models[0][0](Xte[:64]).argmax(-1).cpu().numpy()
    trips = setup.comm.user_round_trips()
    step4 = model.fit_seconds_["federated"]
    parts = res.timings
    row = {"phase": "fit", "engine": model.engine, "layout": fit_layout(model),
           "data_s": data_s, "steps_1_3_s": model.fit_seconds_["protocol"],
           "step_4_s": step4,
           # the first call of the fit's step 4, split: layout, upload and
           # plan lookup ("build"), then the plan's run
           "step_4_parts_s": {"build": step4 - sum(parts.values()), **parts},
           "cache_stats": res.cache_stats,
           "final_loss": res.history[-1]["loss"], "test_accuracy": acc,
           "gram_launches": launches, "users": len(trips),
           "two_communications_per_user": all(v == 2 for v in trips.values())}
    emit(row)
    check(np.isfinite(acc) and 0.0 <= acc <= 1.0, f"accuracy {acc}")
    check(np.isfinite(row["final_loss"]), "non-finite training loss")
    check(len(trips) == D * C and row["two_communications_per_user"],
          f"communications per user {trips}")
    check(np.array_equal(t00, model.predict(Xte[:64])),
          "user (0,0)'s integrated model disagrees with predict")
    check(launches == FIT_LAUNCHES,
          f"gram kernel launches in one fit: {launches} "
          f"(expected {FIT_LAUNCHES})")
    stats = res.cache_stats
    check(not stats["hit"] and stats["captures"] == 1
          and stats["replays"] == model.rounds,
          f"the first scan fit should capture once and replay a round: {stats}")
    return model, (Xs, Ys, Xte, Yte), row


def phase_scan_timing(dev, model, fit_row):
    """Where the scan engine's time goes: a replay per round (a separate
    run whose per-round loss fetch, eval_chunk=1, syncs the card each
    round, on a warm plan), a second tenant in the same bucket (a cache
    hit, nothing captured), and one replayed round under the profiler."""
    loss = partial(mlp.mlp_per_example_loss, task=model.task)
    silos = model.setup_.fed_silos()
    kw = dict(opt=model._opt, rounds=model.rounds,
              local_epochs=model.local_epochs, batch_size=model.batch_size,
              engine="scan", cache=True, device=dev,
              loss_id=("mlp_per_example_loss", model.task),
              opt_id=("adamw", model.lr))
    stamps = []
    ev = lambda _: stamps.append(time.perf_counter()) or {}
    first = run_federated(loss, model.params_, silos, eval_fn=ev,
                          eval_chunk=1, **kw)        # captures the chunk plan
    stamps.clear()
    t0 = time.perf_counter()
    warm = run_federated(loss, model.params_, silos, eval_fn=ev,
                         eval_chunk=1, **kw)
    round_s = np.diff([t0] + stamps)
    check(len(round_s) == model.rounds and warm.cache_stats["hit"],
          f"timing run: {len(round_s)} rounds, {warm.cache_stats}")
    # another tenant of the same bucket: the mnist stand-in drawn anew
    Xs2, Ys2, _, _ = mnist_exp2_layout(seed=1)
    model2 = fit_model(dev, seed=1)
    before = plan_cache_stats()
    _, res2 = model2.fit(Xs2, Ys2)
    new_captures = res2.cache_stats["captures"] - before["captures"]
    check(res2.cache_stats["hit"] and new_captures == 0,
          f"second tenant: {res2.cache_stats} after {before}")
    # one replayed round, profiled: a rounds=1 run on the warm chunk plan
    wall_s, per_kernel, kernels, _ = profile_device(lambda: run_federated(
        loss, model.params_, silos, eval_fn=lambda _: {}, eval_chunk=1,
        **{**kw, "rounds": 1}))
    busy_s = sum(per_kernel.values())
    layout = padded_layout(silos, batch_size=model.batch_size, cache=True)
    vsteps = model.local_epochs * layout.num_batches
    row = {"phase": "scan_timing",
           "bucketed_layout": {"silos": layout.num_silos,
                               "n_slots": layout.n_slots,
                               "batches": layout.num_batches},
           "first_call_s": fit_row["step_4_parts_s"],
           "capture_share_of_first_call": (
               fit_row["step_4_parts_s"]["capture_s"] / fit_row["step_4_s"]),
           "captures_per_fit": fit_row["cache_stats"]["captures"],
           "replays_per_fit": fit_row["cache_stats"]["replays"],
           "chunk_plan_first_call_s": first.timings,
           "replay_round_s": spread(round_s),
           "replay_each_round_s": round_s.tolist(),
           "second_tenant": {"step_4_s": model2.fit_seconds_["federated"],
                             "hit": res2.cache_stats["hit"],
                             "new_captures": new_captures,
                             "timings": res2.timings},
           "profiled_round": {"wall_s": wall_s, "device_busy_s": busy_s,
                              "device_busy_share": busy_s / wall_s,
                              "kernels_run": kernels,
                              "vmapped_steps": vsteps,
                              "kernels_per_step": kernels / vsteps}}
    emit(row)
    return row


def phase_fit_host(dev, data):
    """The same fit with step 4 on the host engine: per-round times from
    each round's host sync (its loss), stamped by eval_fn."""
    Xs, Ys, Xte, Yte = data
    stamps = []
    model = fit_model(dev, engine="host", cache=None,
                      eval_fn=lambda _: stamps.append(time.perf_counter()) or {})
    t0 = time.perf_counter()
    _, res = model.fit(Xs, Ys)
    round_s = np.diff([t0 + model.fit_seconds_["protocol"]] + stamps)
    check(len(round_s) == model.rounds,
          f"{len(round_s)} round times of {model.rounds}")
    acc = model.score(Xte, Yte)
    row = {"phase": "fit_host", "engine": model.engine,
           "layout": fit_layout(model),
           "steps_1_3_s": model.fit_seconds_["protocol"],
           "step_4_s": model.fit_seconds_["federated"],
           "step_4_round_s": spread(round_s),
           "step_4_each_round_s": round_s.tolist(),
           "final_loss": res.history[-1]["loss"], "test_accuracy": acc}
    emit(row)
    check(np.isfinite(acc) and np.isfinite(row["final_loss"]),
          f"host fit: accuracy {acc}, loss {row['final_loss']}")
    return row


def phase_scan_vs_host(dev, model):
    """Both engines on the card, cache off, one injected numpy schedule, at
    the mnist layout: final params and every round's loss within the
    reference's engine bar. Then the hostile-world boundary: the median
    under 30% dropout with one silo submitting −5× its delta."""
    loss = partial(mlp.mlp_per_example_loss, task=model.task)
    silos = model.setup_.fed_silos()
    rounds = SCAN_VS_HOST_ROUNDS
    layout = padded_layout(silos, batch_size=model.batch_size)
    sched = np.stack([round_perms(7, r, layout.num_silos, model.local_epochs,
                                  layout.n_slots) for r in range(rounds)])
    gen = torch.Generator().manual_seed(3)
    p0 = mlp.init_mlp_params(gen, M_TILDE, model.hidden, 10, device=dev)
    scale = [1.0] * D
    scale[D // 2] = -5.0
    cases = {"fedavg": {},
             "median_dropout_scaled": dict(aggregator="median",
                                           dropout_rate=0.3, silo_scale=scale)}
    row = {"phase": "scan_vs_host", "rounds": rounds, "schedule": "numpy",
           "bar": ENGINE_TOL}
    for name, extra in cases.items():
        out = {}
        for engine in ("host", "scan"):
            t0 = time.perf_counter()
            out[engine] = run_federated(
                loss, p0, silos, opt=adamw(model.lr), rounds=rounds,
                local_epochs=model.local_epochs, batch_size=model.batch_size,
                seed=7, engine=engine, schedule=sched, device=dev, **extra)
            torch.cuda.synchronize()
            out[engine + "_s"] = time.perf_counter() - t0
        h, s = out["host"], out["scan"]
        params_gap = max(
            float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for a, b in zip(tree_leaves(s.params), tree_leaves(h.params)))
        loss_gap = max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
                       for a, b in zip(s.history, h.history))
        row[name] = {"params_gap": params_gap, "loss_gap": loss_gap,
                     "host_s": out["host_s"], "scan_s": out["scan_s"],
                     "scan_timings": s.timings}
        check(params_gap <= ENGINE_TOL and loss_gap <= ENGINE_TOL,
              f"scan vs host {name}: params {params_gap}, losses {loss_gap}")
    emit(row)
    return row


def phase_step4_profile(model):
    """One more federated round of the fitted model on the host engine
    under torch.profiler: the device's busy share of that engine's step 4
    (kernel time over wall time; the profiler's own overhead inflates the
    wall, so the share is a floor)."""
    loss = lambda p, x, y: mlp.mlp_per_example_loss(p, x, y, model.task)
    wall_s, per_kernel, kernels, _ = profile_device(lambda: run_federated(
        loss, model.params_, model.setup_.fed_silos(), opt=adamw(model.lr),
        rounds=1, local_epochs=model.local_epochs,
        batch_size=model.batch_size, seed=model.seed + 2, engine="host",
        device=model.device))
    busy_s = sum(per_kernel.values())
    steps = D * model.local_epochs * -(-C * N_IJ // model.batch_size)
    row = {"phase": "step4_profile", "engine": "host", "rounds": 1,
           "optimizer_steps": steps,
           "wall_s": wall_s, "device_busy_s": busy_s,
           "device_busy_share": busy_s / wall_s,
           "kernels_run": kernels, "kernels_per_step": kernels / steps}
    emit(row)
    return row


# -- phase 4 ---------------------------------------------------------------

def phase_device_vs_host(model, data):
    Xs, Ys, Xte, Yte = data
    dev_setup = model.setup_
    t0 = time.perf_counter()
    host = protocol.run_protocol(Xs, Ys, m_tilde=M_TILDE, anchor_r=ANCHOR_R,
                                 seed=model.seed, svd_backend="host")
    host_s = time.perf_counter() - t0
    z_rel = rel(dev_setup.Z, host.Z)
    x_rel = max(rel(a, b) for a, b in zip(dev_setup.collab_X, host.collab_X))
    # a new user joins group 0 of the live deployment; the same roster from
    # scratch, on the same anchor, must agree
    Xn, Yn = Xte[:N_IJ], Yte[:N_IJ]
    dev_setup.onboard_user(0, Xn, Yn)
    Xs2 = [list(r) for r in Xs]
    Ys2 = [list(r) for r in Ys]
    Xs2[0].append(Xn)
    Ys2[0].append(Yn)
    ref = protocol.run_protocol(Xs2, Ys2, m_tilde=M_TILDE, anchor_r=ANCHOR_R,
                                seed=model.seed, svd_backend="device",
                                anchor=dev_setup.anchor, device=model.device)

    def scaled(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(1.0, float(np.abs(np.asarray(b)).max())))

    onboard_err = max([scaled(dev_setup.Z, ref.Z)]
                      + [scaled(a, b) for gi, gr in zip(dev_setup.Gs, ref.Gs)
                         for a, b in zip(gi, gr)]
                      + [scaled(a, b) for a, b in
                         zip(dev_setup.collab_X, ref.collab_X)])
    row = {"phase": "device_vs_host", "host_protocol_s": host_s,
           "z_rel": z_rel, "collab_x_rel_max": x_rel,
           "onboard_vs_recompute_max_scaled_err": onboard_err}
    emit(row)
    check(z_rel <= DEVICE_HOST_TOL and x_rel <= DEVICE_HOST_TOL,
          f"device vs host: Z {z_rel}, collab_X {x_rel}")
    check(onboard_err <= ONBOARD_TOL,
          f"onboarding vs recompute on device: {onboard_err}")
    return row


# -- step 5 as a live service -------------------------------------------------

def _pct(xs, p):
    """The p-th latency as ServeCollab.stats() takes it."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def _serve_pass(srv, spec, pool, params):
    """Submit the requests `spec` [(group, user, row indices into pool)] and
    drain the queue: wall time, rows/s, latency, steps, cache deltas, and
    the largest gap of a served row to the tenant's direct path
    t(x) = h(f(x) G) (float64 map on the host, the MLP on the card)."""
    reqs = [srv.submit(pool[idx], g, u) for g, u, idx in spec]
    before, steps = srv.cache.stats(), srv.steps
    t0 = time.perf_counter()
    out = srv.serve()
    serve_s = time.perf_counter() - t0
    after = srv.cache.stats()
    err = {"abs": 0.0, "scaled": 0.0, "abs_vs_f64": 0.0, "direct_vs_f64": 0.0}
    p64 = tree_map(lambda a: a.double(), params)
    with torch.no_grad():
        for r, (g, u, idx) in zip(reqs, spec):
            h = srv.setup.user_transform(g, u)(pool[idx])
            want = mlp.mlp_forward(params, torch.as_tensor(
                np.asarray(h, np.float32), device=srv.device)).cpu().numpy()
            exact = mlp.mlp_forward(p64, torch.as_tensor(
                h, device=srv.device)).cpu().numpy()
            gap = float(np.abs(out[r.rid] - want).max())
            err["abs"] = max(err["abs"], gap)
            err["scaled"] = max(err["scaled"], gap / max(
                1.0, float(np.abs(want).max())))
            err["abs_vs_f64"] = max(err["abs_vs_f64"], float(
                np.abs(out[r.rid] - exact).max()))
            err["direct_vs_f64"] = max(err["direct_vs_f64"], float(
                np.abs(want - exact).max()))
    rows = sum(len(idx) for _, _, idx in spec)
    lat = [r.latency for r in reqs]
    return {"requests": len(spec), "rows": rows, "serve_s": serve_s,
            "rows_per_s": rows / serve_s, "steps": srv.steps - steps,
            "p50_latency_s": _pct(lat, 0.50), "p99_latency_s": _pct(lat, 0.99),
            "new_plans": after["misses"] - before["misses"],
            "new_captures": after["captures"] - before["captures"],
            "replays": after["replays"] - before["replays"],
            "all_done": set(out.status.values()) == {"done"},
            "max_abs_err_vs_direct": err["abs"],
            "max_scaled_err_vs_direct": err["scaled"],
            # both paths against the direct path evaluated in float64
            "max_abs_err_vs_f64": err["abs_vs_f64"],
            "direct_max_abs_err_vs_f64": err["direct_vs_f64"]}


def phase_serve_collab(dev, model, data):
    """Step 5 as a live multi-tenant service: FedDCL.serve() on the fitted
    mnist-width model (a copy of its setup, so live onboarding leaves the
    other phases' setup as it was). A cold pass of the CLI's stream (1,024
    requests of 1–48 rows, each to a tenant uniform over the 20), the same
    stream warm (nothing new captured), then live onboarding: a new silo
    (4 users, T_pad 4: its Gram kernel launches counted) and a fifth user
    in group 0 (T_pad 4 -> 8: new buckets), each followed by 64 requests
    through the newcomer. Every served row is held to its direct path."""
    _, _, Xte, _ = data
    served = copy.copy(model)
    served.setup_ = copy.deepcopy(model.setup_)
    cache = PlanCache()
    srv = served.serve(max_batch=SERVE_MAX_BATCH, cache=cache)
    check(srv.device == dev and len(srv.tables) == D
          and all(t.t_pad == C for t in srv.tables),
          f"serve tables: {[(t.count, t.t_pad) for t in srv.tables]}")
    rng = np.random.default_rng(7)

    def spec(n, tenants):
        return [(*tenants[int(rng.integers(len(tenants)))],
                 rng.integers(0, len(Xte), int(rng.integers(
                     1, SERVE_MAX_ROWS + 1)))) for _ in range(n)]

    stream = spec(SERVE_REQUESTS, [(g, u) for g in range(D) for u in range(C)])
    passes = {"cold": _serve_pass(srv, stream, Xte, model.params_),
              "warm": _serve_pass(srv, stream, Xte, model.params_)}
    # the same stream once more, under the profiler: the card's share
    for g, u, idx in stream:
        srv.submit(Xte[idx], g, u)
    steps = srv.steps
    wall, per_kernel, kernels, _ = profile_device(srv.serve)
    steps = srv.steps - steps
    busy = sum(per_kernel.values())
    profiled = {"steps": steps, "wall_s": wall, "device_busy_s": busy,
                "device_busy_share": busy / wall,
                "device_us_per_step": busy / steps * 1e6,
                "kernels_per_step": kernels / steps}
    # live onboarding: new data drawn from the stand-in with another seed
    Xs2, Ys2, _, _ = mnist_exp2_layout(seed=2)
    gram_kernel.reset_launches()
    t0 = time.perf_counter()
    gi = srv.onboard_silo(Xs2[0], Ys2[0])
    silo_s = time.perf_counter() - t0
    silo_launches = gram_kernel.launches
    passes["onboard_silo"] = _serve_pass(
        srv, spec(NEWCOMER_REQUESTS, [(gi, u) for u in range(C)]), Xte,
        model.params_)
    gram_kernel.reset_launches()
    t0 = time.perf_counter()
    uj = srv.onboard_user(0, Xs2[1][0], Ys2[1][0])
    user_s = time.perf_counter() - t0
    user_launches = gram_kernel.launches
    passes["onboard_user"] = _serve_pass(
        srv, spec(NEWCOMER_REQUESTS, [(0, uj)]), Xte, model.params_)
    st = srv.stats()
    row = {"phase": "serve_collab", "max_batch": SERVE_MAX_BATCH,
           "max_rows": SERVE_MAX_ROWS, "passes": passes,
           "profiled_warm_pass": profiled,
           "onboard_silo": {"group": gi, "t_pad": srv.tables[gi].t_pad,
                            "s": silo_s, "gram_launches": silo_launches},
           "onboard_user": {"group": 0, "user": uj,
                            "t_pad": srv.tables[0].t_pad, "s": user_s,
                            "gram_launches": user_launches},
           "steps": st["steps"], "buckets": st["buckets"],
           "cache": st["cache"],
           "max_abs_err_vs_direct": max(p["max_abs_err_vs_direct"]
                                        for p in passes.values()),
           "max_scaled_err_vs_direct": max(p["max_scaled_err_vs_direct"]
                                           for p in passes.values()),
           "bar": SERVE_TOL}
    emit(row)
    for name, p in passes.items():
        check(p["all_done"], f"serve_collab {name}: not every request done")
        check(p["max_scaled_err_vs_direct"] <= SERVE_TOL,
              f"serve_collab {name}: served vs direct path "
              f"{p['max_scaled_err_vs_direct']} (scaled)")
        # on the card each new bucket is one captured graph
        check(p["new_captures"] == p["new_plans"],
              f"serve_collab {name}: {p['new_captures']} captures for "
              f"{p['new_plans']} new buckets")
    check(passes["cold"]["new_captures"] > 0
          and passes["warm"]["new_captures"] == 0,
          f"serve_collab: the warm pass captured "
          f"{passes['warm']['new_captures']}")
    check(row["onboard_silo"]["t_pad"] == C and silo_launches > 0,
          f"onboard_silo: {row['onboard_silo']}")
    check(row["onboard_user"]["t_pad"] == 2 * C
          and passes["onboard_user"]["new_captures"] > 0,
          f"onboard_user: {row['onboard_user']}, "
          f"{passes['onboard_user']}")
    return row


# -- the paper's experiments -------------------------------------------------

# the scenario matrix's grid: the full one (d <= 32, c <= 8) runs in well
# under 30 s on the card
SCENARIOS_FAST = False
GRAM_LOOP_SPEEDUP = 3.0   # gram_batched_d16 over gram_group_loop_d16


def phase_paper_experiments(dev):
    """The paper's experiments through the port's scripts, on the card:
    Experiment I at its full layout and Experiment II's mnist column at the
    paper's width (all five methods on the scan engine, FedDCL's step 3 on
    the device backend: the Gram kernel), the host-vs-device scenario
    matrix, the communication count, the plan-cache sweeps and the kernel
    micro-benchmarks, each with the reference's own bar."""
    t_phase = time.perf_counter()
    row = {"phase": "paper_experiments"}
    with tempfile.TemporaryDirectory() as tmp:
        # Experiment I (Fig. 4): only FedDCL's step 3 runs the Gram kernel
        gram_kernel.reset_launches()
        t0 = time.perf_counter()
        res, claims = exp1_convergence.run(engine="scan",
                                           svd_backend="device", device=dev,
                                           out_dir=tmp)
        row["exp1"] = {"wall_s": time.perf_counter() - t0,
                       "rmse": res["metrics"], "times_s": res["times"],
                       "claims": claims,
                       "gram_launches": gram_kernel.launches}
        # Experiment II's mnist column at the paper's width
        gram_kernel.reset_launches()
        t0 = time.perf_counter()
        res = run_all_methods("mnist", d=D, c=C, n_ij=N_IJ, rounds=FIT_ROUNDS,
                              local_epochs=4, epochs=40, engine="scan",
                              svd_backend="device", cache=True, device=dev)
        row["exp2_mnist"] = {"wall_s": time.perf_counter() - t0,
                             "accuracy": res["metrics"],
                             "times_s": res["times"],
                             "gram_launches": gram_kernel.launches}
        # the host-vs-device scenario matrix (steps 1-3)
        gram_kernel.reset_launches()
        t0 = time.perf_counter()
        rows = exp3_groups.scenarios(fast=SCENARIOS_FAST, device=dev,
                                     out_dir=tmp)
        row["scenarios"] = {
            "grid": "fast" if SCENARIOS_FAST else "full",
            "cells": len(rows), "wall_s": time.perf_counter() - t0,
            "rel_frobenius_max": max(r["rel_frobenius"] for r in rows),
            "gram_launches": gram_kernel.launches,
            "speedup": spread(r["speedup"] for r in rows),
            "largest": rows[-1]}
        comm = comm_cost.protocol_comm(device=dev)
        row["comm"] = {**comm, "user_traffic_reduction":
                       comm_cost.user_traffic_reduction(comm)}
        t0 = time.perf_counter()
        sw = sweep.bench_sweep(fast=True, device=dev)
        api = sweep.bench_api_cache(fast=True, device=dev)
        row["sweep"] = {k: sw[k] for k in ("configs", "executables",
                                           "t_cold_total_s", "t_warm_total_s",
                                           "speedup")}
        row["api_cache"] = {k: api[k] for k in ("t_first_s", "t_warm_mean_s",
                                                "speedup")}
        row["sweeps_wall_s"] = time.perf_counter() - t0
    kb = {name: (us, derived)
          for name, us, derived in kernels_bench.run(fast=True, device=dev)}
    row["kernels_bench_us"] = {k: v[0] for k, v in kb.items()}
    row["kernels_bench_derived"] = {k: v[1] for k, v in kb.items()}
    loop_speedup = (kb["gram_group_loop_d16"][0]
                    / kb["gram_batched_d16"][0])
    row["gram_batched_d16_speedup"] = loop_speedup
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    exp1 = row["exp1"]
    check(all(exp1["claims"].values()), f"Exp I claims: {exp1['claims']}")
    check(all(np.isfinite(v) for v in exp1["rmse"].values()),
          f"Exp I RMSEs: {exp1['rmse']}")
    check(exp1["gram_launches"] > 0, "Exp I: FedDCL launched no Gram kernel")
    acc = row["exp2_mnist"]["accuracy"]
    check(all(np.isfinite(v) for v in acc.values()), f"mnist: {acc}")
    check(acc["FedDCL"] > acc["Local"],
          f"mnist: FedDCL {acc['FedDCL']} does not beat Local {acc['Local']}")
    check(row["exp2_mnist"]["gram_launches"] > 0,
          "mnist: FedDCL launched no Gram kernel")
    sc = row["scenarios"]
    check(sc["rel_frobenius_max"] <= DEVICE_HOST_TOL,
          f"scenarios: rel_frobenius {sc['rel_frobenius_max']}")
    check(sc["gram_launches"] > 0, "scenarios: no Gram kernel launch")
    check(comm["feddcl_msgs_per_user"] == 2,
          f"communications per user: {comm['feddcl_msgs_per_user']}")
    check(loop_speedup >= GRAM_LOOP_SPEEDUP,
          f"gram_batched_d16 only {loop_speedup:.2f}x over the loop")
    return row


# -- the scripts that carry the reference's bars ----------------------------

E2E_STEPS, E2E_BATCH, E2E_SEQ = 200, 8, 256   # end_to_end_driver's defaults
E2E_ARGS = ["--steps", str(E2E_STEPS), "--batch", str(E2E_BATCH),
            "--seq", str(E2E_SEQ)]
FED_BENCH_TOL = 1e-4      # host vs scan rel_param_diff (the reference's bar)


def kernel_launch_counts():
    return {"gram": gram_kernel.launches, "flash": fa_kernel.launches(),
            "wkv6": wkv_kernel.launches, "wkv6_bwd": wkv_kernel.grad_launches}


def phase_bar_drivers(dev):
    """The reference's scripts that carry bars, through the port's, on the
    card, each holding its own bars (an assert in a script fails the run):
    serve_bench at its full layout (the warm sweep builds no plan and
    captures no graph, every group's captured step answers from its
    arguments, onboarding agrees with a recompute to 1e-5 and is >= 5x
    faster), robust_ablation at its full sizes (the acceptance asserts;
    host == scan <= 1e-4 for the robust aggregators), fed_bench --fast
    (host vs scan <= 1e-4), and the three examples: the llama-100m
    federated example (200 steps, loss finite and falling), the federated
    pretraining example (80 steps) and the batched server. None of them
    may launch a kernel."""
    t_phase = time.perf_counter()
    row = {"phase": "bar_drivers"}
    launches0 = kernel_launch_counts()
    dev_arg = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        out = ["--out-dir", tmp]
        t0 = time.perf_counter()
        sb = serve_bench.run(fast=False, device=dev)
        s = sb["serve"]
        row["serve_bench"] = {
            "wall_s": time.perf_counter() - t0, "layout": sb["layout"],
            **{k: s[k] for k in ("rows_per_s_warm", "p50_latency_ms",
                                 "p99_latency_ms", "t_cold_s", "t_warm_s",
                                 "plans_cold", "captures_cold",
                                 "compiles_warm", "cache")},
            "t_setup_s": sb["t_setup_s"], "onboard": sb["onboard"]}
        t0 = time.perf_counter()
        ra = robust_ablation.main(["--skip-sharded", *dev_arg, *out])
        row["robust_ablation"] = {
            "wall_s": time.perf_counter() - t0, "sizes": ra["sizes"],
            "rounds": ra["rounds"], "acceptance": ra["acceptance"],
            "engine_agreement_maxdiff": ra["engine_agreement_maxdiff"],
            "cell_s": spread(r["time_s"]
                             for r in ra["grid"] + ra["dropout_grid"])}
        t0 = time.perf_counter()
        fb = fed_bench.main(["--fast", *dev_arg, *out])["cases"]
        row["fed_bench"] = {"wall_s": time.perf_counter() - t0, "cases": fb}
        t0 = time.perf_counter()
        hist = end_to_end_driver.main(E2E_ARGS + dev_arg + out)
        t_train = hist[-1]["elapsed_s"]
        row["end_to_end_driver"] = {
            "wall_s": time.perf_counter() - t0, "steps": E2E_STEPS,
            "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "steps_per_s": E2E_STEPS / t_train,
            "tokens_per_s": E2E_STEPS * E2E_BATCH * E2E_SEQ / t_train}
        t0 = time.perf_counter()
        hist_p = feddcl_llm_pretrain.main(dev_arg + out)
        row["feddcl_llm_pretrain"] = {
            "wall_s": time.perf_counter() - t0,
            "first_loss": hist_p[0]["loss"], "last_loss": hist_p[-1]["loss"]}
        t0 = time.perf_counter()
        served = serve_batched.main(dev_arg)
        row["serve_batched"] = {
            "wall_s": time.perf_counter() - t0, "requests": len(served),
            "tokens": sum(len(v) for v in served.values()),
            "status": sorted(set(served.status.values()))}
    launches1 = kernel_launch_counts()
    row["kernel_launches"] = {k: launches1[k] - launches0[k]
                              for k in launches0}
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    check(s["compiles_warm"] == 0, f"serve_bench warm sweep built {s}")
    check(s["captures_cold"] == s["plans_cold"] > 0,
          f"serve_bench: {s['plans_cold']} plans, {s['captures_cold']} "
          "captures cold")
    check(all(d <= 1e-4 for d in ra["engine_agreement_maxdiff"].values()),
          f"robust_ablation host vs scan {ra['engine_agreement_maxdiff']}")
    check(all(c["rel_param_diff"] <= FED_BENCH_TOL for c in fb),
          f"fed_bench rel_param_diff {[c['rel_param_diff'] for c in fb]}")
    check(len(hist) > 1 and all(np.isfinite(h["loss"]) for h in hist),
          f"end_to_end_driver losses {hist}")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"end_to_end_driver loss {hist[0]['loss']} -> {hist[-1]['loss']}")
    check(row["serve_batched"]["status"] == ["done"],
          f"serve_batched statuses {row['serve_batched']['status']}")
    check(all(v == 0 for v in row["kernel_launches"].values()),
          f"the drivers launched kernels: {row['kernel_launches']}")
    return row


# -- the analysis tier: the artifact audit and idle plans ---------------------

AUDIT_MIN_ELEMS = audit.MIN_ELEMS  # the reference audit script's threshold
CLEAR_REPS = 200          # timed calls of each clear and each serve graph


def idle_plans(plans):
    """What idle plans hold: how many of each kind, how many captured a
    graph, and every non-splat array of >= AUDIT_MIN_ELEMS elements."""
    return {"plans": len(plans),
            "fl_plans": sum(isinstance(p, FLPlan) for p in plans),
            "captured": sum(p.captures for p in plans),
            "non_splat": [{"plan": type(p).__name__, **b} for p in plans
                          for b in find_baked_constants(p, AUDIT_MIN_ELEMS)]}


def fl_reuse(dev, model):
    """Step 4 through the fit's cached plan (its cache key): tenant A (the
    fit's own silos), tenant B (the same silos, rows reversed: the same
    bucket), A again. A's second run must be bitwise its first."""
    loss = partial(mlp.mlp_per_example_loss, task=model.task)
    kw = dict(opt=adamw(model.lr), rounds=model.rounds,
              local_epochs=model.local_epochs, batch_size=model.batch_size,
              engine="scan", cache=True, device=dev,
              loss_id=("mlp_per_example_loss", model.task),
              opt_id=("adamw", model.lr))
    a = model.setup_.fed_silos()
    b = [(x[::-1].copy(), y[::-1].copy()) for x, y in a]
    runs = [run_federated(loss, model.params_, t, **kw) for t in (a, b, a)]
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(runs[0].params), tree_leaves(runs[2].params)))
    losses = [[h["loss"] for h in r.history] for r in runs]
    return {"hits": [r.cache_stats["hit"] for r in runs],
            "a_again_bitwise": same and losses[0] == losses[2],
            "b_differs": losses[0] != losses[1]}


def serve_clears(dev):
    """serve_bench at its full layout after its cold and warm sweeps (its
    own plan cache), then group 0's step at the full bucket: replays of the
    plan's graph (the step, then the in-graph clear of its argument
    buffers) against a graph of the step alone captured over the same
    buffers, in turns, each between CUDA events with the live arguments
    copied in before it; their outputs bitwise; and the output clear after
    the host copy. Returns the row and the server's idle plans."""
    b = serve_bench.build(fast=False, device=dev)
    serve_bench.serve_sweeps(b)
    idle = idle_plans(b.srv.cache.plans())
    step = b.srv.lower_step(0, serve_bench.MAX_BATCH)
    plan = step.plan
    params, M, mu, x, tix = step.args
    live = dict(params=params, M=M, mu=mu, x=x.to(dev), tix=tix.to(dev))
    bufs = plan._bufs
    bare, bare_out = capture(lambda: collab_serve_step(**bufs), dev)

    def fill():
        tree_map(lambda d, a: d.copy_(a), bufs, live)

    fill()
    bare.replay()
    y_bare = bare_out.clone()
    fill()
    plan._graph.replay()
    y_plan = plan._out.clone()
    cleared = all(not bool(t.any()) for t in tree_leaves(bufs))
    times = {"bare": [], "with_clear": []}
    for _ in range(CLEAR_REPS):
        for name, graph in (("bare", bare), ("with_clear", plan._graph)):
            fill()
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            graph.replay()
            e.record()
            times[name].append((s, e))
    torch.cuda.synchronize()
    ms = {k: statistics.median(s.elapsed_time(e) for s, e in v)
          for k, v in times.items()}
    del bare, bare_out
    return {"layout": b.lay, "b_pad": serve_bench.MAX_BATCH,
            "step_ms": ms["bare"], "step_with_clear_ms": ms["with_clear"],
            "in_graph_clear_ms": ms["with_clear"] - ms["bare"],
            "buffers": len(tree_leaves(bufs)),
            "buffer_bytes": sum(t.numel() * t.element_size()
                                for t in tree_leaves(bufs)),
            "out_clear_ms": time_ms(plan._out.zero_, CLEAR_REPS),
            "rows_bitwise_vs_no_clear": torch.equal(y_bare, y_plan),
            "buffers_zero_after_replay": cleared}, idle


def phase_audit(dev, smi):
    """The analysis tier on the card: the audit module's matrix (each
    flavor's plan lowered: built, captured, replayed, held to its eager
    rounds; no baked data), both positive controls caught, the warm
    sentinel; then FedDCL at the mnist width with its defaults
    (run_federated(cache=True)) and FedDCL.serve() through the default
    plan cache at the serve_collab phase's stream, served twice: every
    cached plan holds only splats once idle, a cached FL plan reused by a
    second tenant gives the first bitwise its own answer again, and the
    served rows repeat bitwise. The clears' cost: the FL plan's release
    per run, the serve step's in-graph clear and its output clear per
    step, beside the card's name and power limit."""
    t_phase = time.perf_counter()
    rep = audit.run(dev, AUDIT_MIN_ELEMS)
    row = {"phase": "audit", "nvidia_smi": smi, "min_elems": AUDIT_MIN_ELEMS,
           "flavors": rep["flavors"],
           "closure_control": rep["closure_control"],
           "buffer_control": rep["buffer_control"],
           "warm_recompiles": rep["warm_recompiles"],
           "ranks": rep["ranks"]}
    Xs, Ys, Xte, _ = mnist_exp2_layout()
    clear_plan_cache()
    model = fit_model(dev)
    _, fit = model.fit(Xs, Ys)
    srv = model.serve(max_batch=SERVE_MAX_BATCH)
    rng = np.random.default_rng(7)
    tenants = [(g, u) for g in range(D) for u in range(C)]
    stream = [(*tenants[int(rng.integers(len(tenants)))],
               rng.integers(0, len(Xte), int(rng.integers(
                   1, SERVE_MAX_ROWS + 1)))) for _ in range(SERVE_REQUESTS)]
    served = []
    for _ in range(2):
        reqs = [srv.submit(Xte[idx], g, u) for g, u, idx in stream]
        out = srv.serve()
        served.append([out[r.rid] for r in reqs])
    row["serve_twice_bitwise"] = all(
        np.array_equal(a, b) for a, b in zip(*served))
    row["fl_reuse"] = fl_reuse(dev, model)
    row["idle_default_cache"] = idle_plans(default_plan_cache().plans())
    fl_plan = next(p for p in default_plan_cache().plans()
                   if isinstance(p, FLPlan))
    fl_bufs = [t for t in tree_leaves(fl_plan._bufs.carry) + [
        fl_plan._bufs.X, fl_plan._bufs.Y, fl_plan._bufs.w, fl_plan._bufs.wr,
        fl_plan._bufs.scale, fl_plan._bufs.perms, fl_plan._bufs.loss]
        if t is not None]
    row["fl_clear"] = {
        "ms_per_run": time_ms(fl_plan._release, CLEAR_REPS),
        "buffers": len(fl_bufs),
        "buffer_bytes": sum(t.numel() * t.element_size() for t in fl_bufs),
        "fit_rounds_s": fit.timings["rounds_s"], "rounds": model.rounds}
    row["serve_clear"], row["idle_serve_bench_cache"] = serve_clears(dev)
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    check(rep["ok"], f"audit: {rep}")
    for f in rep["flavors"]:
        # a sharded round is two graphs, one each side of the collective
        graphs = 2 if f["flavor"].startswith("sharded/") else 1
        check(f["plans"] == 1 and f["captures"] == graphs,
              f"audit {f['flavor']}: {f['plans']} plans, {f['captures']} "
              f"captures (1 and {graphs})")
        check(f["max_rel_err_vs_eager"] <= 1e-5,
              f"audit {f['flavor']}: replay vs eager "
              f"{f['max_rel_err_vs_eager']}")
    for name in ("idle_default_cache", "idle_serve_bench_cache"):
        idle = row[name]
        check(idle["captured"] > 0 and not idle["non_splat"],
              f"{name}: idle plans hold {idle['non_splat']}")
    check(row["idle_default_cache"]["fl_plans"] >= 1
          and row["idle_default_cache"]["plans"]
          > row["idle_default_cache"]["fl_plans"],
          f"the default cache lacks an FL or a serve plan: "
          f"{row['idle_default_cache']}")
    check(row["serve_twice_bitwise"], "the stream served twice differs")
    reuse = row["fl_reuse"]
    check(reuse["hits"] == [True, True, True] and reuse["a_again_bitwise"]
          and reuse["b_differs"], f"FL plan reuse: {reuse}")
    sc = row["serve_clear"]
    check(sc["rows_bitwise_vs_no_clear"] and sc["buffers_zero_after_replay"],
          f"serve clear: {sc}")
    return row


# -- step 4 across DC-server processes --------------------------------------

def params_gap(a, b) -> float:
    """Largest leaf gap of two param trees (tensors or arrays), relative
    to max(1, |b|), as scan_vs_host measures."""
    host = lambda t: (t.detach().double().cpu().numpy()
                      if isinstance(t, torch.Tensor) else np.asarray(
                          t, np.float64))
    return max(float(np.abs(host(x) - host(y)).max())
               / max(1.0, float(np.abs(host(y)).max()))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def loss_gap(ha, hb) -> float:
    """Largest gap of two runs' per-round losses, relative to max(1,
    |b|)."""
    return max(abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"]))
               for a, b in zip(ha, hb))


SHARDED_RANKS = 2         # DC-server processes, all on the one card
SHARDED_TOL = 1e-5        # sharded vs unsharded, relative: the reference's bar
# Sharding changes only the order of fp32 sums (the boundary's partial
# sums, the vmapped local phase over 4 silos instead of 8), and from round
# 2 on AdamW amplifies such rounding at the mnist width: on the card, 1e-7
# on the init params parts two unsharded runs by 1.08e-5 after 2 rounds
# and 0.065 after 20, where fedavg's sharded params part by 1.45e-5 and
# 0.073. So the mnist width holds the params to SHARDED_TOL after one
# round (fedavg; the median's order statistics are exact, held after 2)
# and every round's loss to SHARDED_TOL at 2 rounds; at 2 and 20 rounds
# it holds fedavg's params, and at 20 its losses, to YARDSTICK_FACTOR
# times the gap that nudge makes in the same run. fed_bench's sanity
# bound on its d 8 x 20-round row (the 16-32-1 MLP) is held as the
# reference holds it.
SHARDED_SANITY = 1e-2
SANITY_CASE = (8, FIT_ROUNDS, "fedavg")
SHARDED_LEAVES = 6        # the 50-500-100-10 MLP's weights and biases
YARDSTICK = 1e-7          # relative perturbation of the init params
YARDSTICK_FACTOR = 3.0    # sharded gap <= this x the nudge's gap


def phase_sharded(dev, smi):
    """FedDCL's step 4 across SHARDED_RANKS DC-server processes on the
    card: steps 1–3 of the mnist-width fit here, the collaboration
    representations (d 5, bucketed to 8 silos: 4 a rank) to a temporary
    .npz, then ``run_ranks`` starts the ranks, each running
    ``run_federated(mesh=make_host_mesh(), cache=True)`` on its own CUDA
    context on cuda:0 (two captured graphs a round, the collective between
    their replays through pinned host memory over gloo). Held to the
    unsharded scan engine run here on the same layout: fedavg and the
    median under 30% dropout with a silo submitting −5× its delta at
    SCAN_VS_HOST_ROUNDS rounds: every round's loss within SHARDED_TOL;
    the params (relative to max(1, |x|), as scan_vs_host) within it after
    one round of fedavg and after the median's rounds, and within
    YARDSTICK_FACTOR times the gap between two unsharded runs whose init
    differs by YARDSTICK after fedavg's; every
    rank's params bitwise alike; the census (7 all-reduce operands for
    fedavg; 1 all-reduce and 7 all-gather for the median). fedavg at
    FIT_ROUNDS: the timed run (a sharded round, its collective's ms and
    bytes, the unsharded round beside them), its params' and losses' gaps
    within YARDSTICK_FACTOR times the same yardstick's; in the same group
    fed_bench's d 8 x 20-round case within SHARDED_SANITY."""
    t_phase = time.perf_counter()
    Xs, Ys, _, _ = mnist_exp2_layout()
    model = fit_model(dev)
    t0 = time.perf_counter()
    setup = protocol.run_protocol(
        Xs, Ys, m_tilde=model.m_tilde, m_hat=model.m_hat,
        anchor_r=model.anchor_r, anchor_kind=model.anchor_kind,
        mapping_kind=model.mapping_kind, seed=model.seed,
        svd_backend=model.svd_backend, onboard=model.onboard, device=dev)
    steps_1_3_s = time.perf_counter() - t0
    silos = setup.fed_silos()
    p0 = mlp.init_mlp_params(torch.Generator().manual_seed(3), M_TILDE,
                             model.hidden, 10, device=dev)
    scale = [1.0] * D
    scale[D // 2] = -5.0
    base = dict(local_epochs=model.local_epochs, batch_size=model.batch_size,
                seed=7, cache=True, loss_id=("mlp_per_example_loss",
                                             model.task),
                opt_id=("adamw", model.lr))
    runs = {"fedavg_1": dict(base, rounds=1),
            "fedavg": dict(base, rounds=SCAN_VS_HOST_ROUNDS),
            "fedavg_20": dict(base, rounds=FIT_ROUNDS),
            "median_dropout_scaled": dict(
                base, rounds=SCAN_VS_HOST_ROUNDS, aggregator="median",
                dropout_rate=0.3, silo_scale=scale)}
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"mesh": {"model": 1}, "task": model.task,
                "silos": fed_ranks.save_silos(os.path.join(tmp, "silos.npz"),
                                              silos),
                "params": mlp_params_to_numpy(p0),
                "runs": [dict(kw, opt=("adamw", model.lr))
                         for kw in runs.values()]}
        t0 = time.perf_counter()
        per_rank = run_ranks(fed_ranks.serial, SHARDED_RANKS, args=([
            ("fit", spec),
            ("repro_torch.benchmarks.fed_bench:bench_sharded_cases",
             [SANITY_CASE], 1)],), timeout=900)
        ranks_s = time.perf_counter() - t0
    sanity = per_rank[0][1][0]
    per_rank = [r[0] for r in per_rank]
    loss = partial(mlp.mlp_per_example_loss, task=model.task)
    row = {"phase": "sharded", "nvidia_smi": smi, "ranks": SHARDED_RANKS,
           "layout": {**fit_layout(model), "bucketed_silos": 8,
                      "silos_per_rank": 8 // SHARDED_RANKS},
           "steps_1_3_s": steps_1_3_s, "ranks_wall_s": ranks_s}
    refs = {}
    for i, (name, kw) in enumerate(runs.items()):
        got = [r["runs"][i] for r in per_rank]
        ref = refs[name] = run_federated(loss, p0, silos, opt=adamw(model.lr),
                                         engine="scan", device=dev, **kw)
        rel_gap = params_gap(got[0]["params"], ref.params)
        l_gap = loss_gap(got[0]["history"], ref.history)
        bitwise = all(all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(got[0]["params"]), tree_leaves(g["params"])))
            and g["history"] == got[0]["history"] for g in got)
        rounds = kw["rounds"]
        c = got[0]["collectives"]
        round_ms = [1e3 * g["timings"]["rounds_s"] / rounds for g in got]
        row[name] = {
            "rounds": rounds, "rel_param_gap": rel_gap,
            "loss_gap": l_gap,
            "ranks_bitwise": bitwise, "census": c["census"],
            "round_ms_by_rank": round_ms,
            "collective_ms_per_round": c["collective_ms_per_round"],
            "replay_ms_per_round": round_ms[0] - c["collective_ms_per_round"],
            "staged_bytes_per_round": c["staged_bytes_per_round"],
            "wire_bytes_per_round": c["wire_bytes_per_round"],
            "first_call_s": {k: v for k, v in got[0]["timings"].items()
                             if k != "rounds_s"},
            "unsharded_round_ms": 1e3 * ref.timings["rounds_s"] / rounds,
            "final_loss": got[0]["history"][-1]["loss"],
            "unsharded_final_loss": ref.history[-1]["loss"]}
    for name in ("fedavg", "fedavg_20"):
        nudged = run_federated(
            loss, tree_map(lambda a: a * (1 + YARDSTICK), p0), silos,
            opt=adamw(model.lr), engine="scan", device=dev, **runs[name])
        row[name]["unsharded_vs_nudged_init_gap"] = params_gap(
            nudged.params, refs[name].params)
        row[name]["unsharded_vs_nudged_init_loss_gap"] = loss_gap(
            nudged.history, refs[name].history)
    row["sanity_case"] = {k: sanity[k] for k in (
        "d", "rounds", "aggregator", "rel_param_diff", "collectives",
        "t_vmap_warm_s", "t_sharded_warm_s")}
    row["wall_s"] = time.perf_counter() - t_phase
    emit(row)
    weighted = {"all-reduce": SHARDED_LEAVES + 1}
    robust = {"all-reduce": 1, "all-gather": SHARDED_LEAVES + 1}
    check(sanity["rel_param_diff"] <= SHARDED_SANITY,
          f"sharded vs unsharded {SANITY_CASE}: {sanity['rel_param_diff']}")
    check(sanity["collectives"] == {"all-reduce": sanity["param_leaves"] + 1},
          f"sharded {SANITY_CASE} census {sanity['collectives']}")
    for name, census in (("fedavg_1", weighted), ("fedavg", weighted),
                         ("fedavg_20", weighted),
                         ("median_dropout_scaled", robust)):
        r = row[name]
        nudge = YARDSTICK_FACTOR * r.get("unsharded_vs_nudged_init_gap", 0)
        bar = nudge or SHARDED_TOL
        check(r["rel_param_gap"] <= bar,
              f"sharded vs unsharded {name}: {r['rel_param_gap']} > {bar}")
        bar = (YARDSTICK_FACTOR * r["unsharded_vs_nudged_init_loss_gap"]
               if name == "fedavg_20" else SHARDED_TOL)
        check(r["loss_gap"] <= bar,
              f"sharded vs unsharded {name} losses: {r['loss_gap']} > {bar}")
        check(r["ranks_bitwise"], f"sharded {name}: the ranks disagree")
        check(r["census"] == census, f"sharded {name} census {r['census']}")
        check(np.isfinite(r["final_loss"]), f"sharded {name} loss")
        check(r["staged_bytes_per_round"] > 0,
              f"sharded {name}: nothing staged through the host")
    return row


# -- phase 5: flash attention, kernel vs plain -------------------------------

def visible_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask lets through: the work the function
    needs, whatever tiles a kernel visits."""
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq)
    return int(np.clip(hi - lo, 0, None).sum())


def library_call(q, k, v, Sq, Sk, window, softcap, q_offset):
    """One PyTorch call computing the same function on the same inputs, as
    (name, fn): SDPA, or, with a softcap (which SDPA lacks), flex_attention
    compiled with the tanh softcap as its score_mod and the causal / window
    mask as its block mask (built once, outside the call). Model layout in,
    (B, H, S, hd) views to the library."""
    F = torch.nn.functional
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if softcap:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def visible(b, h, q_idx, kv_idx):
            qpos = q_idx + q_offset
            keep = kv_idx <= qpos
            if window:
                keep = keep & (kv_idx > qpos - window)
            return keep

        def capped(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)

        mask = create_block_mask(visible, None, None, Sq, Sk, device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)
        return "flex_attention", lambda: flex(
            qh, kh, vh, score_mod=capped, block_mask=mask, enable_gqa=True)
    if window == 0 and q_offset == 0 and Sq == Sk:
        return "sdpa", lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return "sdpa", lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def work_bounds(peak, dtype, flops, nbytes):
    """The least time for a function's work, `nbytes` moved and `flops`
    done at the dtype's fastest route: bf16 on the tensor cores;
    fp32-accurate as FFMA or as three TF32 products on the tensor cores,
    whichever is faster (as gram_bounds). Returns (bound ms, "operations"
    or "bytes", the route that bounds the operations, the FFMA-only bound
    ms or None)."""
    t_bytes = nbytes / peak["bytes"] * 1e3
    if dtype == torch.bfloat16:
        t_ops, kind, t_ffma = flops / peak["bf16_flops"] * 1e3, "bf16", None
    else:
        t_ffma = flops / peak["fp32_flops"] * 1e3
        t_tf32 = 3.0 * flops / peak["tf32_flops"] * 1e3
        t_ops, kind = ((t_tf32, "3xtf32") if t_tf32 <= t_ffma
                       else (t_ffma, "ffma"))
        t_ffma = max(t_ffma, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, kind, t_ffma


def phase_flash_check(dev, peak):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, B, H, KV, Sq, Sk, hd, window, softcap, q_offset in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dtype)
            kw = dict(causal=True, window=window, softcap=softcap,
                      q_offset=q_offset)
            before = dict(fa_kernel.route_launches)
            out = fa_ops.flash_attention(q, k, v, **kw)
            ran = [r for r, n in fa_kernel.route_launches.items()
                   if n != before[r]]
            check(len(ran) == 1 and fa_kernel.route_launches[ran[0]]
                  == before[ran[0]] + 1,
                  f"flash call at {name} {dtype}: launches by route "
                  f"{before} -> {fa_kernel.route_launches}")
            ref = fa_ops.flash_attention(q, k, v, backend="ref", **kw)
            lib_name, lib = library_call(q, k, v, Sq, Sk, window, softcap,
                                         q_offset)
            lib_out = lib()
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]

            def err(x):
                diff = (x.float() - ref.float()).abs()
                return (float(diff.max()),
                        float((diff / (tol + tol * ref.float().abs())).max()))
            (max_abs, excess), (lib_abs, lib_excess) = err(out), err(
                lib_out.transpose(1, 2))
            del out, ref, lib_out
            pairs = visible_pairs(Sq, Sk, True, window, q_offset)
            flops = 4.0 * hd * B * H * pairs
            nbytes = float(q.element_size() * (2 * q.numel() + 2 * k.numel()))
            bound_ms, bound_by, bound_kind, ffma_bound_ms = work_bounds(
                peak, dtype, flops, nbytes)
            reps = 3 if flops > 1e11 else 10
            kernel = lambda: fa_ops.flash_attention(q, k, v, **kw)
            ms = time_ms(kernel, reps)
            plain_ms = time_ms(lambda: fa_ops.flash_attention(
                q, k, v, backend="ref", **kw), reps)
            library_ms = time_ms(lib, reps)
            # the card's time alone (graph replay)
            device_ms = graph_ms(kernel, 1 if flops > 1e11 else 10, reps=3)
            row = {"phase": "flash_check", "shape": name, "route": ran[0],
                   "B_H_KV_Sq_Sk_hd": [B, H, KV, Sq, Sk, hd],
                   "window": window, "softcap": softcap,
                   "q_offset": q_offset, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": max_abs, "tol": tol,
                   "err_over_bar": excess, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                   "library": lib_name, "library_ms": library_ms,
                   "library_max_abs_err": lib_abs,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_kind": bound_kind, "ffma_bound_ms": ffma_bound_ms,
                   "share_of_bound": bound_ms / ms,
                   "visible_pairs": pairs, "tflops_per_s": flops / ms / 1e9}
            emit(row)
            rows.append(row)
            check(excess <= 1.0, f"flash kernel vs plain at {name} {dtype}: "
                                 f"max abs {max_abs} over the {tol} bar")
            # the yardstick must compute the same function to be one
            check(lib_excess <= 1.0, f"{lib_name} vs plain at {name} {dtype}: "
                                     f"max abs {lib_abs} over the {tol} bar")
            del q, k, v
    torch.cuda.empty_cache()
    return rows


# -- phase 6: llama3.2-1b prefill and decode --------------------------------

def wall_s(fn, reps: int = 3) -> float:
    """Median host wall time of fn() ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def random_tokens(seed, shape, vocab, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, shape, dtype=np.int64),
                           device=dev)


def bf16_gaps(cfg, p16, prompt, ref_logits, cache_len, dev):
    """The bf16 prefill's last-token logits on `prompt`, kernel path (the
    wgmma kernel, counted) and plain path, each against `ref_logits` (the
    fp32 plain path's): relative gaps, launches and times."""
    kw = dict(cache_len=cache_len, device=dev)
    with_k = make_prefill_step(cfg, **kw)
    plain = make_prefill_step(cfg, use_kernels=False, **kw)
    fa_kernel.reset_launches()
    lk, _, _ = with_k(p16, prompt)
    torch.cuda.synchronize()
    launches = dict(fa_kernel.route_launches)
    lp, _, _ = plain(p16, prompt)
    return {"kernel_path_rel": rel(lk.float().cpu(), ref_logits.cpu()),
            "plain_path_rel": rel(lp.float().cpu(), ref_logits.cpu()),
            "launches": launches,
            "kernel_path_s": wall_s(lambda: with_k(p16, prompt), reps=1),
            "plain_path_s": wall_s(lambda: plain(p16, prompt), reps=1),
            "logits_finite": bool(torch.isfinite(lk).all())}


def check_bf16_gap(gap, name):
    check(gap["logits_finite"], f"{name} bf16 kernel-path logits")
    check(gap["launches"][fa_kernel.F32_ROUTE] == 0
          and gap["launches"][fa_kernel.BF16_ROUTE] > 0,
          f"{name} bf16 prefill launches by route: {gap['launches']}")
    check(gap["kernel_path_rel"] <= BF16_GAP * gap["plain_path_rel"],
          f"{name} bf16 kernel path vs fp32 plain: {gap['kernel_path_rel']} "
          f"> {BF16_GAP} x the bf16 plain path's {gap['plain_path_rel']}")


def phase_llm_prefill(dev):
    cfg = LLAMA
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = random_tokens(0, (PREFILL_B, PREFILL_S), cfg.vocab_size, dev)
    step = make_prefill_step(cfg, cache_len=PREFILL_CACHE, device=dev)
    fa_kernel.reset_launches()
    logits, state, nxt = step(p16, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = fa_kernel.route_launches[fa_kernel.BF16_ROUTE]
    check(launches == cfg.num_layers and fa_kernel.launches() == launches,
          f"bf16 wgmma flash launches in one llama prefill: {launches} of "
          f"{fa_kernel.launches()} (expected {cfg.num_layers})")
    check(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "bf16 prefill logits")
    prefill_s = wall_s(lambda: step(p16, {"tokens": tokens}))
    _, per_kernel, _, _ = profile_device(
        lambda: step(p16, {"tokens": tokens}))
    dev_s = sum(per_kernel.values())
    share = sum(t for k, t in per_kernel.items()
                if "flash_fwd_kernel_wgmma" in k) / dev_s

    # fp32: the kernel path against the plain path of the same model, and
    # prefill(prompt + t) against prefill(prompt) then one decode of t
    kw = dict(cache_len=PREFILL_CACHE, compute_dtype=torch.float32,
              cache_dtype=torch.float32, device=dev)
    with_k = make_prefill_step(cfg, **kw)
    plain = make_prefill_step(cfg, use_kernels=False, **kw)
    tok1 = random_tokens(1, (1, PREFILL_S + 1), cfg.vocab_size, dev)
    prompt = {"tokens": tok1[:, :PREFILL_S]}
    lk, s32, n32 = with_k(p32, prompt)
    lp, _, _ = plain(p32, prompt)
    kernel_vs_plain = rel(lk.cpu(), lp.cpu())
    lfull, _, _ = with_k(p32, {"tokens": tok1})
    ldec, _ = make_serve_step(cfg, compute_dtype=torch.float32, device=dev)(
        p32, s32, tok1[:, PREFILL_S:], n32)
    prefill_vs_decode = rel(ldec.cpu(), lfull.cpu())
    fp32_kernel_s = wall_s(lambda: with_k(p32, prompt), reps=1)
    fp32_plain_s = wall_s(lambda: plain(p32, prompt), reps=1)
    del s32
    # bf16 on the same prompt: the kernel path's gap to the fp32 plain path
    # against the bf16 plain path's own gap to it
    bf16_gap = bf16_gaps(cfg, p16, prompt, lp, PREFILL_CACHE, dev)
    row = {"phase": "llm_prefill", "arch": cfg.name,
           "params": cfg.param_count(), "init_s": init_s,
           "bf16": {"batch": PREFILL_B, "seq": PREFILL_S,
                    "cache_len": PREFILL_CACHE, "flash_launches": launches,
                    "prefill_s": prefill_s,
                    "prefill_tokens_per_s": PREFILL_B * PREFILL_S / prefill_s,
                    "flash_share_of_device_time": share,
                    "profiled_device_s": dev_s, "b1_vs_fp32_plain": bf16_gap},
           "fp32_b1": {"kernel_vs_plain_logits_rel": kernel_vs_plain,
                       "prefill_plus_t_vs_decode_rel": prefill_vs_decode,
                       "kernel_path_s": fp32_kernel_s,
                       "plain_path_s": fp32_plain_s}}
    emit(row)
    check(kernel_vs_plain <= LM_TOL,
          f"llama fp32 kernel vs plain logits: {kernel_vs_plain}")
    check(prefill_vs_decode <= LM_TOL,
          f"llama prefill(P+t) vs prefill(P)+decode(t): {prefill_vs_decode}")
    check_bf16_gap(bf16_gap, cfg.name)
    return p32, p16, logits, state, nxt, row


def phase_llm_decode(dev, p32, p16, logits, state, nxt):
    cfg = LLAMA
    serve_step = make_serve_step(cfg, device=dev)
    tok = logits[:, 0].argmax(-1, keepdim=True)
    pos = nxt.clone()

    def decode_run():
        nonlocal tok, pos
        for _ in range(DECODE_STEPS):
            out, _ = serve_step(p16, state, tok, pos)
            tok = out[:, 0].argmax(-1, keepdim=True)
            pos = pos + 1
        return out

    fa_kernel.reset_launches()
    decode_runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_run()
        torch.cuda.synchronize()
        decode_runs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()), "decode logits")
    decode_s = statistics.median(decode_runs)
    check(fa_kernel.launches() == 0, "decode runs no flash kernel")
    prof_wall, per_kernel, kernels, _ = profile_device(decode_run)
    busy_s = sum(per_kernel.values())
    graph = captured_decode(cfg, p16, state, tok, pos, dev)

    # BatchedServer at full width, as serve.py:main runs it
    def requests():   # a Request keeps its output: fresh ones each run
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=rng.integers(4, 12)),
                        max_new=16) for i in range(8)]

    serve_runs = []
    for _ in range(REPEATS):
        reqs = requests()
        server = BatchedServer(cfg, p32, slots=4, cache_len=256, device=dev,
                               capture=False)
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        torch.cuda.synchronize()
        serve_runs.append(time.perf_counter() - t0)
        check(set(outs.status.values()) == {"done"}
              and all(len(v) == 16 for v in outs.values()),
              f"server statuses {outs.status}")
    serve_s = statistics.median(serve_runs)
    total = sum(len(v) for v in outs.values())
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    captured_server = captured_server_runs(cfg, p32, requests, outs, dev,
                                           cache_len=256)
    row = {"phase": "llm_decode", "arch": cfg.name,
           "bf16": {"batch": PREFILL_B, "steps": DECODE_STEPS,
                    "start_pos": PREFILL_S, "decode_s": decode_s,
                    "ms_per_step": decode_s / DECODE_STEPS * 1e3,
                    "decode_tokens_per_s":
                        PREFILL_B * DECODE_STEPS / decode_s,
                    "decode_tokens_per_s_spread": spread(
                        PREFILL_B * DECODE_STEPS / t for t in decode_runs),
                    "profiled_device_busy_share": busy_s / prof_wall,
                    "device_ms_per_step": busy_s / DECODE_STEPS * 1e3,
                    "kernels_per_step": kernels / DECODE_STEPS,
                    "graph": graph},
           "server_fp32": {"requests": len(reqs), "slots": 4,
                           "cache_len": 256, "max_new": 16,
                           "prompt_tokens": prompt_tokens,
                           "new_tokens": total, "serve_s": serve_s,
                           "server_tokens_per_s": total / serve_s,
                           "server_tokens_per_s_spread": spread(
                               total / t for t in serve_runs),
                           "status": sorted(set(outs.status.values())),
                           "captured": captured_server}}
    emit(row)
    check_graph_rows(cfg.name, graph, captured_server)
    return row


def captured_decode(cfg, params, state, tok, pos, dev, compute_dtype=None):
    """The same greedy decode as the eager rows, through the captured step
    (one CUDA graph for this state): tokens/s over REPEATS runs of
    DECODE_STEPS, the device's busy share and kernels of a profiled run of
    PROFILE_STEPS, and the captured vs eager logits gap over GAP_STEPS
    steps from two copies of the state on the same tokens."""
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    step = make_captured_serve_step(cfg, device=dev, **kw)
    B = tok.shape[0]

    def run(steps=DECODE_STEPS):
        nonlocal tok, pos
        for _ in range(steps):
            out, _ = step(params, state, tok, pos)
            tok = out[:, 0].argmax(-1, keepdim=True)
            pos = pos + 1
        return out

    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()), "captured decode logits")
    wall, per_kernel, kernels, _ = profile_device(lambda: run(PROFILE_STEPS))
    busy = sum(per_kernel.values())
    eager = make_serve_step(cfg, device=dev, **kw)
    s_e, s_c = (tree_map(torch.clone, state) for _ in range(2))
    t, p, gap, gap_abs = tok.clone(), pos.clone(), 0.0, 0.0
    for _ in range(GAP_STEPS):
        le, _ = eager(params, s_e, t, p)
        lc, _ = step(params, s_c, t, p)
        gap = max(gap, rel(lc.double().cpu(), le.double().cpu()))
        gap_abs = max(gap_abs, float((lc - le).abs().max()))
        t, p = le[:, 0].argmax(-1, keepdim=True), p + 1
    del s_e, s_c
    med = statistics.median(runs)
    return {"decode_s": med, "ms_per_step": med / DECODE_STEPS * 1e3,
            "decode_tokens_per_s": B * DECODE_STEPS / med,
            "decode_tokens_per_s_spread": spread(
                B * DECODE_STEPS / r for r in runs),
            "profiled_device_busy_share": busy / wall,
            "device_ms_per_step": busy / PROFILE_STEPS * 1e3,
            "kernels_per_step": kernels / PROFILE_STEPS,
            "captures": step.captures, "replays": step.replays,
            "vs_eager_logits_rel": gap, "vs_eager_logits_max_abs": gap_abs}


def captured_server_runs(cfg, params, requests, eager_outs, dev, **kw):
    """BatchedServer on its CUDA default, the captured decode (one graph a
    slot, one for the full batch): a cold run that captures them, then
    REPEATS warm runs on the same server; every run's tokens equal to the
    eager server's (`eager_outs`)."""
    server = BatchedServer(cfg, params, slots=4, device=dev, **kw)
    runs, same = [], []
    for _ in range(1 + REPEATS):
        t0 = time.perf_counter()
        outs = server.serve(requests())
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        same.append(dict(outs) == dict(eager_outs)
                    and outs.status == eager_outs.status)
    total = sum(len(v) for v in outs.values())
    return {"cold_serve_s": runs[0], "serve_s": statistics.median(runs[1:]),
            "server_tokens_per_s": total / statistics.median(runs[1:]),
            "server_tokens_per_s_spread": spread(total / t for t in runs[1:]),
            "cold_server_tokens_per_s": total / runs[0],
            "captures": server.captures, "slots": server.slots,
            "tokens_equal_eager": all(same)}


def check_graph_rows(name, graph, server):
    check(graph["vs_eager_logits_rel"] <= GRAPH_TOL,
          f"{name} captured vs eager decode logits: "
          f"{graph['vs_eager_logits_rel']}")
    check(graph["captures"] == 2,
          f"{name} captured decode: {graph['captures']} captures (expected "
          f"one for the timed state and one for the gap's copy)")
    check(server["tokens_equal_eager"],
          f"{name} captured server's tokens differ from the eager server's")
    check(server["captures"] == server["slots"] + 1,
          f"{name} captured server: {server['captures']} captures for "
          f"{server['slots']} slots")


# -- phase 7: gemma2-2b prefill past its window -------------------------------

def phase_gemma2_prefill(dev):
    cfg = GEMMA
    gen = torch.Generator(device=dev).manual_seed(2)
    params = bb.init_params(cfg, gen, torch.float32, device=dev)
    tokens = {"tokens": random_tokens(2, (1, GEMMA_S), cfg.vocab_size, dev)}
    kw = dict(cache_len=GEMMA_S, compute_dtype=torch.float32,
              cache_dtype=torch.float32, device=dev)
    with_k = make_prefill_step(cfg, **kw)
    plain = make_prefill_step(cfg, use_kernels=False, **kw)
    fa_kernel.reset_launches()
    lk, _, _ = with_k(params, tokens)
    torch.cuda.synchronize()
    launches = fa_kernel.route_launches[fa_kernel.F32_ROUTE]
    all_launches = fa_kernel.launches()
    lp, _, _ = plain(params, tokens)
    err = rel(lk.cpu(), lp.cpu())
    kernel_s = wall_s(lambda: with_k(params, tokens), reps=1)
    plain_s = wall_s(lambda: plain(params, tokens), reps=1)
    finite = bool(torch.isfinite(lk).all())
    del lk
    # bf16, 26 launches of the wgmma kernel at hd 256, held as llama's is
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    torch.cuda.empty_cache()
    bf16 = bf16_gaps(cfg, p16, tokens, lp, GEMMA_S, dev)
    bf16["prefill_tokens_per_s"] = GEMMA_S / bf16["kernel_path_s"]
    row = {"phase": "gemma2_prefill", "arch": cfg.name,
           "params": cfg.param_count(), "batch": 1, "seq": GEMMA_S,
           "window": cfg.sliding_window, "dtype": "float32",
           "flash_launches": launches, "all_launches": all_launches,
           "kernel_vs_plain_logits_rel": err,
           "kernel_path_s": kernel_s, "plain_path_s": plain_s,
           "prefill_tokens_per_s": GEMMA_S / kernel_s,
           "logits_finite": finite, "bf16": bf16}
    emit(row)
    check(launches == cfg.num_layers and row["all_launches"] == launches,
          f"fp32 3xTF32 flash launches in one gemma2 prefill: {launches} of "
          f"{row['all_launches']} (expected {cfg.num_layers})")
    check(row["logits_finite"], "gemma2 logits")
    check(err <= LM_TOL, f"gemma2 fp32 kernel vs plain logits: {err}")
    check(bf16["launches"][fa_kernel.BF16_ROUTE] == cfg.num_layers,
          f"bf16 wgmma flash launches in one gemma2 prefill: "
          f"{bf16['launches']} (expected {cfg.num_layers})")
    check_bf16_gap(bf16, cfg.name)
    del p16
    torch.cuda.empty_cache()
    return row


# -- phase 8: WKV6, kernel vs plain -------------------------------------------

def wkv6_inputs(gen, B, S, H, K, V, dev):
    """r, k, v, log_w, u as the reference's tests draw them."""
    n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lw = -torch.exp(torch.clamp(n(B, S, H, K), -8.0, 1.6))
    return n(B, S, H, K), n(B, S, H, K), n(B, S, H, V), lw, n(H, K) * 0.3


def leaf_rel_max(a_tree, b_tree) -> float:
    return max(rel(a.float().cpu(), b.float().cpu())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def loss_grads(cfg, params, batch, use_kernels):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = bb.loss_fn(live, batch, cfg, use_kernels=use_kernels,
                         remat=False, compute_dtype=torch.float32)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def phase_wkv6_check(dev, peak):
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for name, B, S, H, K, V in WKV_SHAPES:
        args = wkv6_inputs(gen, B, S, H, K, V, dev)
        out = wkv_ops.wkv6(*args)
        torch.cuda.synchronize()
        errs = {}
        for backend in ("scan", "chunked"):
            ref = wkv_ops.wkv6(*args, backend=backend)
            diff = (out - ref).abs()
            errs[backend] = (float(diff.max()), float(
                (diff / (WKV_ATOL + WKV_RTOL * ref.abs())).max()))
        ms = time_ms(lambda: wkv_ops.wkv6(*args), 20)
        device_ms = graph_ms(lambda: wkv_ops.wkv6(*args), 20)
        plain_ms = time_ms(lambda: wkv_ops.wkv6(*args, backend="chunked"), 20)
        scan_ms = time_ms(lambda: wkv_ops.wkv6(*args, backend="scan"), 2)
        # per (token, head): 4KV flops; r, k, log_w, v read, o written once
        pairs = B * S * H
        flops = 4.0 * K * V * pairs
        nbytes = 4.0 * ((3 * K + 2 * V) * pairs + H * K)
        bound_ms, bound_by, bound_kind, ffma_bound_ms = work_bounds(
            peak, torch.float32, flops, nbytes)
        row = {"phase": "wkv6_check", "shape": name,
               "B_S_H_K_V": [B, S, H, K, V],
               "max_abs_err_vs_scan": errs["scan"][0],
               "max_abs_err_vs_chunked": errs["chunked"][0],
               "err_over_bar": max(e[1] for e in errs.values()),
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
               "scan_ms": scan_ms,
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_kind": bound_kind,
               "ffma_bound_ms": ffma_bound_ms,
               "bytes_bound_ms": nbytes / peak["bytes"] * 1e3,
               "gbytes_per_s": nbytes / ms / 1e6}
        emit(row)
        rows.append(row)
        check(row["err_over_bar"] <= 1.0,
              f"wkv6 kernel vs plain at {name}: {errs}")
        del args, out

    # gradients at the train shape: the gradient kernel against the closed
    # form (ref.wkv6_grad) and against autograd of the plain chunked form,
    # each gradient; then WKV6Function (both kernels, through autograd)
    _, B, S, H, K, V = WKV_SHAPES[0]
    args = wkv6_inputs(gen, B, S, H, K, V, dev)
    cot = torch.randn((B, S, H, V), generator=gen, device=dev)
    before = wkv_kernel.grad_launches
    got = wkv_kernel.wkv6_grad_cuda(*args, cot)
    torch.cuda.synchronize()
    check(wkv_kernel.grad_launches == before + 1,
          "wkv6_grad_cuda launched its kernel other than once")
    closed = wkv_ops.ref.wkv6_grad(*args, cot)
    gb = [t.clone().requires_grad_() for t in args]
    (wkv_ops.ref.wkv6_chunked(*gb) * cot).sum().backward()
    names = ("r", "k", "v", "log_w", "u")
    vs_closed = {n: rel(g.cpu(), w.cpu()) for n, g, w in zip(names, got, closed)}
    vs_autograd = {n: rel(g.cpu(), b.grad.cpu())
                   for n, g, b in zip(names, got, gb)}
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, closed))
    ga = [t.clone().requires_grad_() for t in args]
    (wkv_ops.wkv6(*ga) * cot).sum().backward()
    op_grad_rel = max(rel(a.grad.cpu(), b.grad.cpu()) for a, b in zip(ga, gb))
    bwd_ms = time_ms(lambda: wkv_kernel.wkv6_grad_cuda(*args, cot), 20)
    bwd_device_ms = graph_ms(lambda: wkv_kernel.wkv6_grad_cuda(*args, cot),
                             10)
    # the plain recompute: autograd of the chunked form, what
    # WKV6Function.backward ran once per layer before the gradient kernel
    recompute_ms = time_ms(lambda: torch.autograd.grad(
        wkv_ops.ref.wkv6_chunked(*gb), gb, cot), 10)
    rows[0]["backward_ms"] = bwd_ms
    rows[0]["backward_device_ms"] = bwd_device_ms
    rows[0]["backward_recompute_ms"] = recompute_ms
    rows[0]["backward_max_abs_err"] = max_abs
    # the gradient's bound: r, k, v, log_w, dO and u read once, dr, dk, dv,
    # dw and du written once; 10 K V flops per (token, head): the state
    # recomputed, dS carried back, and dr°, dk°, dv (2 K V each; dlog_w's
    # identity and the u terms need no K V product)
    pairs = B * S * H
    bwd_flops = 10.0 * K * V * pairs
    bwd_bytes = 4.0 * ((3 * K + 2 * V) * pairs + (3 * K + V) * pairs
                       + 2 * H * K)
    (rows[0]["backward_bound_ms"], rows[0]["backward_bound_by"],
     rows[0]["backward_bound_kind"], rows[0]["backward_ffma_bound_ms"]) = (
        work_bounds(peak, torch.float32, bwd_flops, bwd_bytes))
    del args, ga, gb, cot, got, closed
    # ... and of a full-width rwkv6-3b at reduced depth, fp32, kernel path
    # against plain path
    cfg = RWKV.with_overrides(num_layers=GRAD_LAYERS)
    params = bb.init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                            device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in
         TokenStream(cfg.vocab_size, TRAIN_S, 1, seed=1).batch(0).items()}
    lk, gk = loss_grads(cfg, params, b, True)
    lp, gp = loss_grads(cfg, params, b, False)
    model_grad_rel = leaf_rel_max(gk, gp)
    row = {"phase": "wkv6_grad_check", "op_shape": list(WKV_SHAPES[0][1:]),
           "kernel_vs_closed_form_rel": vs_closed,
           "kernel_vs_chunked_autograd_rel": vs_autograd,
           "max_abs_err_vs_closed_form": max_abs,
           "function_grad_rel_max": op_grad_rel,
           "bwd_ms": bwd_ms, "device_ms": bwd_device_ms,
           "plain_ms": recompute_ms, "library_ms": None,
           "backward_flops": bwd_flops, "backward_bytes": bwd_bytes,
           "backward_bound_ms": rows[0]["backward_bound_ms"],
           "backward_bound_by": rows[0]["backward_bound_by"],
           "backward_bound_kind": rows[0]["backward_bound_kind"],
           "backward_ffma_bound_ms": rows[0]["backward_ffma_bound_ms"],
           "model_layers": GRAD_LAYERS,
           "model_tokens": TRAIN_S, "model_loss_rel": rel(lk, lp),
           "model_grad_rel_max": model_grad_rel}
    emit(row)
    check(max(vs_closed.values()) <= WKV_GRAD_TOL
          and max(vs_autograd.values()) <= WKV_GRAD_TOL,
          f"wkv6 gradient kernel vs plain: {vs_closed} {vs_autograd}")
    check(op_grad_rel <= WKV_GRAD_TOL,
          f"WKV6Function gradients: {op_grad_rel}")
    check(model_grad_rel <= LM_TOL and rel(lk, lp) <= LM_TOL,
          f"rwkv6 kernel vs plain path gradients: {model_grad_rel}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return rows


# -- phase 9: rwkv6-3b training at full width --------------------------------

def phase_rwkv6_train(dev, wkv_main):
    cfg = RWKV
    # TrainConfig's defaults (params fp32, compute bf16, AdamW fp32, remat
    # on, lr 3e-4, wd 0.1, clip 1.0), warm-up shortened to the run
    tc = TrainConfig(model=cfg, shape=InputShape("chip", TRAIN_S, TRAIN_B,
                                                 "train"),
                     warmup_steps=2, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    params = bb.init_params(cfg, torch.Generator(device=dev).manual_seed(5),
                            device=dev)
    step, opt = make_train_step(cfg, tc, device=dev)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    stream = TokenStream(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    losses, step_s, per_step, per_step_bwd = [], [], [], []
    # the plain chunked form must not run on this path: count its calls
    plain_calls = []
    plain_chunked = wkv_ops.ref.wkv6_chunked

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain_chunked(*a, **kw)
    torch.cuda.reset_peak_memory_stats()
    wkv_kernel.reset_launches()
    wkv_ops.ref.wkv6_chunked = counted
    try:
        for i in range(TRAIN_STEPS):
            before = (wkv_kernel.launches, wkv_kernel.grad_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, stream.batch(i))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(wkv_kernel.launches - before[0])
            per_step_bwd.append(wkv_kernel.grad_launches - before[1])
    finally:
        wkv_ops.ref.wkv6_chunked = plain_chunked
    launches = wkv_kernel.launches
    bwd_launches = wkv_kernel.grad_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_s = statistics.median(step_s[1:])

    wall, per_kernel, kernels, runs = profile_device(
        lambda: step(params, opt_state, stream.batch(TRAIN_STEPS)))
    dev_s = sum(per_kernel.values())
    wkv_s = sum(t for k, t in per_kernel.items()
                if "wkv6_chunked_fwd_kernel" in k)
    bwd_s = sum(t for k, t in per_kernel.items()   # key and value kernels
                if "wkv6_chunked_bwd_" in k)
    # a gradient call launches two kernels: each once a layer in that step
    bwd_runs = {kind: sum(n for k, n in runs.items()
                          if f"wkv6_chunked_bwd_{kind}_kernel" in k)
                for kind in ("key", "value")}
    del opt_state
    torch.cuda.empty_cache()

    # fp32, no autograd: the kernel path's loss and final hidden states
    # against the plain path's
    b = {k: torch.as_tensor(v, device=dev) for k, v in
         TokenStream(cfg.vocab_size, TRAIN_S, 1, seed=2).batch(0).items()}
    f32 = dict(compute_dtype=torch.float32)
    with torch.no_grad():
        wkv_kernel.reset_launches()
        t0 = time.perf_counter()
        lk = float(bb.loss_fn(params, b, cfg, **f32)[0])
        kernel_s = time.perf_counter() - t0
        fp32_launches = wkv_kernel.launches
        t0 = time.perf_counter()
        lp = float(bb.loss_fn(params, b, cfg, use_kernels=False, **f32)[0])
        plain_s = time.perf_counter() - t0
        hk = bb.forward(params, b["tokens"], cfg, return_logits=False,
                        **f32)[1]
        hp = bb.forward(params, b["tokens"], cfg, use_kernels=False,
                        return_logits=False, **f32)[1]
        hidden_rel = rel(hk.cpu(), hp.cpu())
        del hk, hp
    row = {"phase": "rwkv6_train", "arch": cfg.name,
           "params": cfg.param_count(),
           "train_config": {"param_dtype": tc.param_dtype,
                            "compute_dtype": tc.compute_dtype,
                            "opt_state_dtype": tc.opt_state_dtype,
                            "optimizer": tc.optimizer, "remat": tc.remat,
                            "learning_rate": tc.learning_rate,
                            "warmup_steps": tc.warmup_steps},
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
           "init_s": init_s, "params_and_opt_state_gb": state_gb,
           "losses": losses, "loss_fell": losses[-1] < losses[0],
           "step_s": step_s, "steady_step_s": steady_s,
           "steady_step_s_spread": spread(step_s[1:]),
           "train_tokens_per_s": TRAIN_B * TRAIN_S / steady_s,
           "max_memory_allocated_gb": peak_gb,
           "wkv6_launches": launches, "wkv6_launches_per_step": per_step,
           "wkv6_bwd_launches": bwd_launches,
           "wkv6_bwd_launches_per_step": per_step_bwd,
           "wkv6_bwd_kernel_runs_in_profiled_step": bwd_runs,
           "plain_chunked_calls": len(plain_calls),
           "profiled_step_wall_s": wall, "profiled_device_s": dev_s,
           "device_busy_share": dev_s / wall, "kernels_per_step": kernels,
           "wkv6_fwd_device_s": wkv_s, "wkv6_bwd_device_s": bwd_s,
           "wkv6_fwd_share_of_device_time": wkv_s / dev_s,
           "wkv6_bwd_share_of_device_time": bwd_s / dev_s,
           # the same two shares from CUDA-event times of the two kernels at
           # the train shape (phase wkv6_check), over the unprofiled step
           "wkv6_fwd_event_share_of_step": per_step[-1] * wkv_main["ms"]
                                           / 1e3 / steady_s,
           "wkv6_bwd_event_share_of_step": per_step_bwd[-1]
                                           * wkv_main["backward_ms"] / 1e3
                                           / steady_s,
           "fp32_b1": {"loss_kernel_path": lk, "loss_plain_path": lp,
                       "rel": rel(lk, lp), "hidden_rel": hidden_rel,
                       "wkv6_launches": fp32_launches,
                       "kernel_path_s": kernel_s, "plain_path_s": plain_s}}
    emit(row)
    check(all(np.isfinite(losses)), f"rwkv6 train losses {losses}")
    check(all(n == 2 * cfg.num_layers for n in per_step)
          and all(n == cfg.num_layers for n in per_step_bwd),
          f"wkv6 launches per train step: forward {per_step}, gradient "
          f"{per_step_bwd}")
    check(all(n == cfg.num_layers for n in bwd_runs.values()),
          f"wkv6 gradient kernels in the profiled step: {bwd_runs}")
    check(not plain_calls,
          f"the plain chunked form ran {len(plain_calls)} times in training")
    check(fp32_launches == cfg.num_layers,
          f"wkv6 launches in the fp32 loss: {fp32_launches}")
    check(row["fp32_b1"]["rel"] <= LM_TOL and hidden_rel <= LM_TOL,
          f"rwkv6 fp32 loss kernel vs plain path: {row['fp32_b1']}")
    return row, params


def phase_rwkv6_serve(dev, params):
    """rwkv6-3b serving at full width and depth on the trained params: a
    bf16-compute prefill of 4 x 1024 (the chunked plain form, as in the
    reference: the WKV6 kernel returns no final state, so no launch), then
    greedy decode from its state, eager and captured, on bf16 weights (the
    decay and bonus stay fp32, as a bf16 init keeps them); BatchedServer
    in fp32, eager and captured, as llama's; and prefill(S-1) + one decode
    against forward's last logits in fp32."""
    cfg = RWKV
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    for name in ("decay_base", "bonus"):
        p16["layers"]["tm"][name] = params["layers"]["tm"][name]
    tokens = {"tokens": random_tokens(
        3, (RWKV_PREFILL_B, RWKV_PREFILL_S), cfg.vocab_size, dev)}
    step = make_prefill_step(cfg, cache_len=RWKV_PREFILL_S, device=dev)
    wkv_kernel.reset_launches()
    logits, state, nxt = step(p16, tokens)
    torch.cuda.synchronize()
    prefill_launches = wkv_kernel.launches
    check(tuple(logits.shape) == (RWKV_PREFILL_B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "rwkv6 bf16 prefill logits")
    prefill_s = wall_s(lambda: step(p16, tokens))

    # greedy decode from the prefill state, eager then captured
    serve_step = make_serve_step(cfg, device=dev)
    tok = logits[:, 0].argmax(-1, keepdim=True)
    pos = nxt.clone()

    def decode_run(steps=DECODE_STEPS):
        nonlocal tok, pos
        for _ in range(steps):
            out, _ = serve_step(p16, state, tok, pos)
            tok = out[:, 0].argmax(-1, keepdim=True)
            pos = pos + 1
        return out

    decode_runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_run()
        torch.cuda.synchronize()
        decode_runs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()), "rwkv6 decode logits")
    prof_wall, per_kernel, kernels, _ = profile_device(
        lambda: decode_run(PROFILE_STEPS))
    busy_s = sum(per_kernel.values())
    graph = captured_decode(cfg, p16, state, tok, pos, dev)
    del p16, state, logits

    # BatchedServer at full width in fp32, as llama's
    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=rng.integers(4, 12)),
                        max_new=16) for i in range(8)]

    serve_runs = []
    for _ in range(REPEATS):
        server = BatchedServer(cfg, params, slots=4, device=dev,
                               capture=False)
        t0 = time.perf_counter()
        outs = server.serve(requests())
        torch.cuda.synchronize()
        serve_runs.append(time.perf_counter() - t0)
        check(set(outs.status.values()) == {"done"}
              and all(len(v) == 16 for v in outs.values()),
              f"rwkv6 server statuses {outs.status}")
    del server
    total = sum(len(v) for v in outs.values())
    captured_server = captured_server_runs(cfg, params, requests, outs, dev)

    # fp32: prefill(S-1) then one decode against forward's last logits
    f32 = dict(compute_dtype=torch.float32)
    t32 = random_tokens(4, (1, RWKV_CHECK_S), cfg.vocab_size, dev)
    with torch.no_grad():
        full = bb.forward(params, t32, cfg, **f32)[0][:, -1].float().cpu()
        wkv_kernel.reset_launches()
        _, s32, n32 = make_prefill_step(cfg, cache_len=RWKV_CHECK_S,
                                        device=dev, **f32)(
            params, {"tokens": t32[:, :-1]})
        fp32_prefill_launches = wkv_kernel.launches
        dec, _ = make_serve_step(cfg, device=dev, **f32)(
            params, s32, t32[:, -1:], n32)
    prefill_vs_forward = rel(dec[:, 0].cpu(), full)
    serve_s = statistics.median(serve_runs)
    dec_s = statistics.median(decode_runs)
    B = RWKV_PREFILL_B
    row = {"phase": "rwkv6_serve", "arch": cfg.name,
           "params": cfg.param_count(),
           "bf16": {"batch": B, "seq": RWKV_PREFILL_S,
                    "prefill_s": prefill_s,
                    "prefill_tokens_per_s": B * RWKV_PREFILL_S / prefill_s,
                    "prefill_wkv6_launches": prefill_launches,
                    "decode_steps": DECODE_STEPS, "decode_s": dec_s,
                    "ms_per_step": dec_s / DECODE_STEPS * 1e3,
                    "decode_tokens_per_s": B * DECODE_STEPS / dec_s,
                    "decode_tokens_per_s_spread": spread(
                        B * DECODE_STEPS / t for t in decode_runs),
                    "profiled_device_busy_share": busy_s / prof_wall,
                    "device_ms_per_step": busy_s / PROFILE_STEPS * 1e3,
                    "kernels_per_step": kernels / PROFILE_STEPS,
                    "graph": graph},
           "server_fp32": {"requests": 8, "slots": 4, "max_new": 16,
                           "new_tokens": total, "serve_s": serve_s,
                           "server_tokens_per_s": total / serve_s,
                           "server_tokens_per_s_spread": spread(
                               total / t for t in serve_runs),
                           "captured": captured_server},
           "fp32_b1": {"seq": RWKV_CHECK_S,
                       "prefill_plus_decode_vs_forward_rel":
                           prefill_vs_forward,
                       "prefill_wkv6_launches": fp32_prefill_launches}}
    emit(row)
    check(prefill_launches == 0 and fp32_prefill_launches == 0,
          f"rwkv6 prefill launched the WKV6 kernel "
          f"({prefill_launches}, {fp32_prefill_launches}): its state needs "
          f"the chunked plain form")
    check(prefill_vs_forward <= LM_TOL,
          f"rwkv6 prefill(S-1)+decode vs forward: {prefill_vs_forward}")
    check_graph_rows(cfg.name, graph, captured_server)
    return row


# -- phase 11: FedDCL's federated rwkv6-3b training at full width ---------

def silos_equal(tree) -> bool:
    return all(torch.equal(a[i], a[0]) for a in tree_leaves(tree)
               for i in range(1, a.shape[0]))


def state_zeroed(tree) -> bool:
    return all(not bool(t.any()) for t in tree_leaves(tree))


def fed_batches(cfg, rounds):
    """Per-silo TokenStream batches of the given rounds, (R, H, d, b, S)."""
    out = [[silo_batches(cfg.vocab_size, TRAIN_S, FED_B, FED_D,
                         r * FED_H + h, seed=0) for h in range(FED_H)]
           for r in rounds]
    return {k: np.stack([np.stack([b[k] for b in rnd]) for rnd in out])
            for k in out[0][0]}


def phase_rwkv6_federated(dev, sp, train_row):
    """FedDCL's launch tier on rwkv6-3b at full width and depth: FED_D
    silos, each FED_H local steps a round, then the round boundary, from
    the trained params stacked per silo (`sp`, contiguous: the steps write
    each silo's slice in place). Round 0 runs step by step (the local steps
    timed, the silos compared before and after the sync), then
    FED_ROUND_STEPS rounds through round_step and FED_R rounds in one
    multi_step call; then one profiled local step, one profiled fedavg
    sync, and the three aggregators' syncs timed alone. Then the reduced
    train() CLI on the card: llama3.2-1b (plain attention) and the
    federated rwkv6-3b with both dispatch forms, a trailing phase and a
    checkpoint read back."""
    cfg = RWKV
    fed = FederatedConfig(num_silos=FED_D, local_steps=FED_H)
    n_rounds = 1 + FED_ROUND_STEPS + FED_R
    tc = TrainConfig(model=cfg, shape=InputShape("chip", TRAIN_S,
                                                 FED_D * FED_B, "train"),
                     federated=fed, warmup_steps=2,
                     total_steps=n_rounds * FED_H,
                     opt_state_dtype="bfloat16")
    local_step, opt = make_federated_local_step(cfg, tc, device=dev)
    round_step, _ = make_federated_round_step(cfg, tc, device=dev)
    multi_step, _ = make_federated_multiround_step(cfg, tc, device=dev)
    syncs = {agg: make_fedavg_sync_step(
        replace(tc, federated=replace(fed, aggregator=agg)), device=dev)
        for agg in FED_SYNCS}
    so = silo_opt_init(opt, sp)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    leaves = tree_leaves(sp)
    tokens_per_round = FED_D * FED_H * FED_B * TRAIN_S
    expect = (FED_D * FED_H * 2 * cfg.num_layers,
              FED_D * FED_H * cfg.num_layers)

    plain_calls = []
    plain_chunked = wkv_ops.ref.wkv6_chunked

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain_chunked(*a, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    losses, step_s, launches, equal_after_sync = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    alloc_before = torch.cuda.memory_stats()
    wkv_kernel.reset_launches()
    wkv_ops.ref.wkv6_chunked = counted
    try:
        # round 0, step by step
        b0 = tree_map(lambda a: a[0], fed_batches(cfg, [0]))
        t_first = time.perf_counter()
        for h in range(FED_H):
            (sp, so, m), t = timed(lambda: local_step(
                sp, so, tree_map(lambda a: a[h], b0)))
            step_s.append(t / FED_D)
            losses += m["loss"].flatten().tolist()
            if h == 0:
                differing = sum(not torch.equal(a[0], a[1]) for a in leaves)
        sample = leaves[::5]
        pre = [a.view(FED_D, -1)[:, :FED_SAMPLE].double().mean(0)
               for a in sample]
        (sp, so), sync0_s = timed(lambda: syncs["fedavg"](sp, so))
        first_round_s = time.perf_counter() - t_first
        equal_after_sync.append(silos_equal(sp))
        zeroed = state_zeroed(so)
        mean_rel = max(rel(a.view(FED_D, -1)[0, :FED_SAMPLE].cpu(), p.cpu())
                       for a, p in zip(sample, pre))
        del pre
        launches.append((wkv_kernel.launches, wkv_kernel.grad_launches))

        round_s = []
        for rnd in range(1, 1 + FED_ROUND_STEPS):
            before = (wkv_kernel.launches, wkv_kernel.grad_launches)
            b = tree_map(lambda a: a[0], fed_batches(cfg, [rnd]))
            (sp, so, m), t = timed(lambda: round_step(sp, so, b))
            round_s.append(t)
            # feddcl-lint: disable=R008  the phase checks and times each round on its own: one fetch a round is what it measures
            losses += m["loss"].flatten().tolist()
            equal_after_sync.append(silos_equal(sp))
            launches.append((wkv_kernel.launches - before[0],
                             wkv_kernel.grad_launches - before[1]))

        before = (wkv_kernel.launches, wkv_kernel.grad_launches)
        mb = fed_batches(cfg, range(1 + FED_ROUND_STEPS, n_rounds))
        (sp, so, mm), multi_s = timed(lambda: multi_step(sp, so, mb))
        losses += mm["loss"].flatten().tolist()
        equal_after_sync.append(silos_equal(sp))
        launches += [tuple((n - b_) / FED_R for n, b_ in zip(
            (wkv_kernel.launches, wkv_kernel.grad_launches), before))] * FED_R
    finally:
        wkv_ops.ref.wkv6_chunked = plain_chunked
    fed_launches = wkv_kernel.launches
    fed_bwd_launches = wkv_kernel.grad_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    alloc = {k: torch.cuda.memory_stats()[k] - alloc_before[k] for k in
             ("num_alloc_retries", "num_device_alloc", "num_device_free")}
    alloc["max_memory_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    multi_shape = tuple(mm["loss"].shape)

    # one local step and one fedavg sync under the profiler, then each
    # aggregator's sync alone (the silos are equal by then: a sync's work
    # does not depend on its values)
    b = tree_map(lambda a: a[0, 0], fed_batches(cfg, [n_rounds]))
    step_wall, step_dev, step_kernels, _ = profile_device(
        lambda: local_step(sp, so, b))
    sync_wall, sync_dev, sync_kernels, _ = profile_device(
        lambda: syncs["fedavg"](sp, so))
    sync_ms = {}
    for agg in FED_SYNCS:
        _, t = timed(lambda: syncs[agg](sp, so))
        sync_ms[agg] = t * 1e3
        check(silos_equal(sp) and state_zeroed(so),
              f"silos or optimizer state after a timed {agg} sync")
    del sp, so
    torch.cuda.empty_cache()

    # the reduced train() CLI on the card
    before = fa_kernel.launches()
    wkv_kernel.reset_launches()
    (_, dense_hist), dense_s = timed(lambda: train(
        "llama3.2-1b", reduced=True, steps=4, log_every=1, device=dev))
    dense_flash = fa_kernel.launches() - before
    wkv_kernel.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "rwkv6-3b-reduced.npz")
        (params, fed_hist), fed_cli_s = timed(lambda: train(
            "rwkv6-3b", reduced=True, silos=2, local_steps=2, steps=11,
            rounds_per_dispatch=2, log_every=1, checkpoint_path=ck,
            device=dev))
        restored = store.load(ck, params)
        ck_equal = all(torch.equal(a, b_) for a, b_ in
                       zip(tree_leaves(params), tree_leaves(restored)))
        ck_meta = store.load_metadata(ck)
    small = REDUCED["rwkv6-3b"]
    cli_launches = (wkv_kernel.launches, wkv_kernel.grad_launches)
    cli_expect = (11 * 2 * small.num_layers, 11 * 2 * small.num_layers)

    med_round = statistics.median(round_s)
    row = {"phase": "rwkv6_federated", "arch": cfg.name,
           "params": cfg.param_count(), "silos": FED_D, "local_steps": FED_H,
           "per_silo_batch": FED_B, "seq": TRAIN_S,
           "train_config": {"param_dtype": tc.param_dtype,
                            "compute_dtype": tc.compute_dtype,
                            "opt_state_dtype": tc.opt_state_dtype,
                            "remat": tc.remat, "aggregator": fed.aggregator},
           "cut": "AdamW moments in bf16 (the rwkv6_train row keeps fp32)",
           "rounds": {"first (step by step)": 1,
                      "round_step": FED_ROUND_STEPS, "multi_step": FED_R},
           "stacked_params_and_opt_state_gb": state_gb,
           "max_memory_allocated_gb": peak_gb,
           # the caching allocator over the rounds: a retry frees its
           # cached blocks (a device sync) and calls cudaMalloc again
           "allocator": alloc,
           "first_round_s": first_round_s,
           "round_s": spread(round_s),
           "multi_step_s": multi_s, "multi_step_s_per_round": multi_s / FED_R,
           "local_step_s_per_silo": spread(step_s),
           "baseline_step_s": train_row["steady_step_s"],
           "federated_train_tokens_per_s": tokens_per_round / med_round,
           "baseline_train_tokens_per_s": train_row["train_tokens_per_s"],
           "sync_ms": sync_ms, "first_fedavg_sync_ms": sync0_s * 1e3,
           "losses": losses,
           "silo_leaves_differing_after_first_local_step":
               [differing, len(leaves)],
           "silos_bitwise_equal_after_each_sync": equal_after_sync,
           "fedavg_vs_float64_mean_rel": mean_rel,
           "opt_state_zero_after_fedavg": zeroed,
           "multi_step_metrics_shape": multi_shape,
           "wkv6_launches_per_round": [list(x) for x in launches],
           "wkv6_launches_per_round_expected": list(expect),
           "wkv6_launches": fed_launches,
           "wkv6_bwd_launches": fed_bwd_launches,
           "plain_chunked_calls": len(plain_calls),
           "profiled_local_step": {
               "wall_s": step_wall, "device_s": sum(step_dev.values()),
               "device_busy_share": sum(step_dev.values()) / step_wall,
               "kernels": step_kernels},
           "profiled_fedavg_sync": {
               "wall_s": sync_wall, "device_s": sum(sync_dev.values()),
               "device_busy_share": sum(sync_dev.values()) / sync_wall,
               "kernels": sync_kernels},
           "train_cli": {
               "dense": {"arch": "llama3.2-1b", "reduced": True, "steps": 4,
                         "s": dense_s, "flash_launches": dense_flash,
                         "losses": [r["loss"] for r in dense_hist]},
               "federated": {"arch": "rwkv6-3b", "reduced": True,
                             "silos": 2, "local_steps": 2, "steps": 11,
                             "rounds_per_dispatch": 2, "s": fed_cli_s,
                             "logged_steps": [r["step"] for r in fed_hist],
                             "losses": [r["loss"] for r in fed_hist],
                             "wkv6_launches": list(cli_launches),
                             "checkpoint_reads_back_bitwise": ck_equal,
                             "checkpoint_metadata": ck_meta}}}
    emit(row)
    check(all(np.isfinite(losses)), f"federated losses {losses}")
    check(differing > 0, "the silos' params did not part after the first "
          "local step: the stack aliases one storage")
    check(all(equal_after_sync), f"silos after each sync: {equal_after_sync}")
    check(mean_rel <= FED_MEAN_TOL,
          f"fedavg vs the float64 mean of the silos: {mean_rel}")
    check(zeroed, "the optimizer state after a fedavg sync is not zero")
    check(multi_shape == (FED_R, FED_H),
          f"multi_step's metrics shape {multi_shape}")
    check(all(tuple(x) == expect for x in launches),
          f"wkv6 launches per round {launches}, expected {expect}")
    check(not plain_calls,
          f"the plain chunked form ran {len(plain_calls)} times")
    check(dense_flash == 0 and all(np.isfinite(r["loss"])
                                   for r in dense_hist)
          and [r["step"] for r in dense_hist] == [0, 1, 2, 3],
          f"dense train() on the card: {row['train_cli']['dense']}")
    check([r["step"] for r in fed_hist] == list(range(11))
          and all(np.isfinite(r["loss"]) for r in fed_hist),
          f"federated train() on the card: {row['train_cli']['federated']}")
    check(cli_launches == cli_expect,
          f"wkv6 launches of the federated train(): {cli_launches}, "
          f"expected {cli_expect}")
    check(ck_equal and ck_meta == {"arch": small.name, "steps": 11,
                                   "reduced": True},
          f"the federated train()'s checkpoint: {ck_equal}, {ck_meta}")
    return row


# -- phase 13: granite-moe-1b-a400m, the moe family ---------------------------

@contextlib.contextmanager
def router_trace():
    """Record every router call's chosen experts and selection scores, in
    call order (one call a moe layer), while the block runs."""
    calls = []
    real = model_layers._router_probs

    def traced(p, x2d, mo):
        gates, idx, probs = real(p, x2d, mo)
        sel = probs + p["router_bias"].float() if "router_bias" in p else probs
        calls.append((idx, sel))
        return gates, idx, probs

    model_layers._router_probs = traced
    try:
        yield calls
    finally:
        model_layers._router_probs = real


def routing_flips(got, ref, cfg, margin_bar=None):
    """Tokens whose chosen experts differ between two traced runs (`got`
    against `ref`, layer by layer), with the (token, slot) pairs whose
    kept-or-dropped fate differs. A flip in the first layer that has any
    is primary (the paths' inputs there differ by rounding only) and gets
    its top-k margin in `ref`'s scores; a later flip may follow from an
    earlier one (a flipped token's output moves by O(1), and so do the
    keys and values other tokens read). With `margin_bar`, primary flips
    at or above it are counted as unexplained."""
    mo = cfg.moe
    per_layer, drops, primary, first = [], [], [], None
    for layer, ((ig, _), (ir, sr)) in enumerate(zip(got, ref)):
        flipped = (ig.sort(-1).values != ir.sort(-1).values).any(-1)
        per_layer.append(int(flipped.sum()))
        T = ir.shape[0]
        cap = max(int(mo.capacity_factor * T * mo.top_k / mo.num_experts), 1)
        keep_g = model_layers.moe_dispatch(ig, cap, mo.num_experts)[2]
        keep_r = model_layers.moe_dispatch(ir, cap, mo.num_experts)[2]
        drops.append(int((keep_g != keep_r).sum()))
        if first is None and per_layer[-1]:
            first = layer
            top = sr.topk(mo.top_k + 1, dim=-1).values
            margins = (top[:, mo.top_k - 1] - top[:, mo.top_k])[flipped]
            tokens = flipped.nonzero()[:, 0]
            primary = [{"token": int(t), "margin": float(m)}
                       for t, m in zip(tokens.tolist(), margins.tolist())]
    out = {"decisions": sum(i.shape[0] for i, _ in ref),
           "flipped": sum(per_layer), "flipped_per_layer": per_layer,
           "kept_pairs_changed_per_layer": drops,
           "first_flip_layer": first, "primary_flips": primary[:16],
           "primary_count": len(primary),
           "primary_max_margin": max((f["margin"] for f in primary),
                                     default=None)}
    if margin_bar is not None:
        out["margin_bar"] = margin_bar
        out["unexplained"] = sum(f["margin"] >= margin_bar for f in primary)
    return out


def rel_dev(a, b) -> float:
    """rel() on the card, for tensors too large to bring over."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def state_rel(state, ref_state) -> float:
    """rel over every float leaf of two decode states together: every
    layer's cached keys and values (and a hybrid's Mamba2 conv windows and
    SSM states)."""
    num = den = 0.0
    for a, b in zip(tree_leaves(state), tree_leaves(ref_state)):
        if b.is_floating_point():
            a, b = a.double(), b.double()
            num += float(torch.sum(torch.square(a - b)))
            den += float(torch.sum(torch.square(b)))
    return (num / max(den, 1e-300)) ** 0.5


def granite_prefills(cfg, p32, p16, dev):
    """fp32 and bf16 prefills of the same GRANITE_B x GRANITE_S prompt,
    each on the kernel path (counted by route) and on the plain path, the
    routing of each traced. Returns (row, the bf16 kernel path's logits and
    state for decode)."""
    tokens = {"tokens": random_tokens(13, (GRANITE_B, GRANITE_S),
                                      cfg.vocab_size, dev)}
    f32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    steps = {(dt, k): make_prefill_step(cfg, cache_len=GRANITE_CACHE,
                                        use_kernels=k, device=dev,
                                        **(f32 if dt == "fp32" else {}))
             for dt in ("fp32", "bf16") for k in (True, False)}
    params = {"fp32": p32, "bf16": p16}
    out, traces, launches, secs = {}, {}, {}, {}
    for dt in ("fp32", "bf16"):
        for k in (True, False):
            fa_kernel.reset_launches()
            with router_trace() as calls:
                out[dt, k] = steps[dt, k](params[dt], tokens)
                torch.cuda.synchronize()
            traces[dt, k] = calls
            launches[dt, k] = dict(fa_kernel.route_launches)
            secs[dt, k] = wall_s(lambda: steps[dt, k](params[dt], tokens),
                                 reps=3 if (dt, k) == ("bf16", True) else 1)
    _, per_kernel, kernels, _ = profile_device(
        lambda: steps["bf16", True](p16, tokens))
    dev_s = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    logits = {key: o[0] for key, o in out.items()}
    ref_logits, ref_state = logits["fp32", False], out["fp32", False][1]
    lrel = {key: rel_dev(logits[key], ref_logits) for key in logits}
    crel = {key: state_rel(out[key][1], ref_state) for key in out}
    row = {"batch": GRANITE_B, "seq": GRANITE_S, "cache_len": GRANITE_CACHE,
           "bf16": {
               "flash_launches": launches["bf16", True],
               "plain_path_launches": launches["bf16", False],
               "prefill_s": secs["bf16", True],
               "prefill_tokens_per_s": GRANITE_B * GRANITE_S
                                       / secs["bf16", True],
               "plain_path_s": secs["bf16", False],
               "profiled_device_s": dev_s, "kernels": kernels,
               "flash_share_of_device_time": sum(
                   t for n, t in per_kernel.items()
                   if "flash_fwd_kernel_wgmma" in n) / dev_s,
               "top_kernels_s": top,
               "vs_fp32_plain": {
                   "kernel_path_logits_rel": lrel["bf16", True],
                   "plain_path_logits_rel": lrel["bf16", False],
                   "kernel_path_cache_rel": crel["bf16", True],
                   "plain_path_cache_rel": crel["bf16", False]},
               "logits_finite": bool(torch.isfinite(
                   logits["bf16", True]).all()),
               "flips_kernel_vs_plain": routing_flips(
                   traces["bf16", True], traces["bf16", False], cfg),
               "flips_plain_vs_fp32_plain": routing_flips(
                   traces["bf16", False], traces["fp32", False], cfg)},
           "fp32": {
               "flash_launches": launches["fp32", True],
               "kernel_path_s": secs["fp32", True],
               "plain_path_s": secs["fp32", False],
               "kernel_vs_plain_logits_rel": lrel["fp32", True],
               "kernel_vs_plain_cache_rel": crel["fp32", True],
               "flips_kernel_vs_plain": routing_flips(
                   traces["fp32", True], traces["fp32", False], cfg,
                   FLIP_MARGIN)}}
    keep = out["bf16", True]
    del out, traces
    return row, keep


def greedy_run(step, params, state, tok, pos, n):
    """n greedy decode steps: (tokens (n, B), the logits of each step)."""
    toks, logits = [], []
    for _ in range(n):
        out, _ = step(params, state, tok, pos)
        logits.append(out.clone())
        tok = out[:, 0].argmax(-1, keepdim=True)
        toks.append(tok[:, 0])
        pos = pos + 1
    return torch.stack(toks), logits


def lm_prefills(cfg, p32, p16, B, S, cache_len, seed, dev):
    """fp32 and bf16 prefills of the same B x S prompt (after a prefix
    family's prefix, drawn by ``synthetic_prefix``), each on the kernel
    path (counted by route) and on the plain path; the bf16 kernel path
    profiled. Returns (row, the bf16 kernel path's logits, state and next
    position for decode)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": random_tokens(seed, (B, S), cfg.vocab_size, dev)}
    if cfg.prefix_frontend:
        batch["prefix_embeds"] = synthetic_prefix(gen, cfg, B, device=dev)
    f32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
    steps = {(dt, k): make_prefill_step(cfg, cache_len=cache_len,
                                        use_kernels=k, device=dev,
                                        **(f32 if dt == "fp32" else {}))
             for dt in ("fp32", "bf16") for k in (True, False)}
    params = {"fp32": p32, "bf16": p16}
    out, launches, secs = {}, {}, {}
    for dt in ("fp32", "bf16"):
        for k in (True, False):
            fa_kernel.reset_launches()
            out[dt, k] = steps[dt, k](params[dt], batch)
            torch.cuda.synchronize()
            launches[dt, k] = dict(fa_kernel.route_launches)
            secs[dt, k] = wall_s(lambda: steps[dt, k](params[dt], batch),
                                 reps=3 if (dt, k) == ("bf16", True) else 1)
    _, per_kernel, kernels, _ = profile_device(
        lambda: steps["bf16", True](p16, batch))
    dev_s = sum(per_kernel.values())
    logits = {key: o[0] for key, o in out.items()}
    ref_logits, ref_state = logits["fp32", False], out["fp32", False][1]
    lrel = {key: rel_dev(logits[key], ref_logits) for key in logits}
    srel = {key: state_rel(out[key][1], ref_state) for key in out}
    T = cfg.prefix_len + S
    row = {"batch": B, "seq": S, "prefix_len": cfg.prefix_len,
           "cache_len": cache_len,
           "next_pos": sorted(set(out["bf16", True][2].tolist())),
           "bf16": {
               "flash_launches": launches["bf16", True],
               "plain_path_launches": launches["bf16", False],
               "prefill_s": secs["bf16", True],
               "prefill_tokens_per_s": B * T / secs["bf16", True],
               "plain_path_s": secs["bf16", False],
               "profiled_device_s": dev_s, "kernels": kernels,
               "flash_share_of_device_time": sum(
                   t for n, t in per_kernel.items()
                   if "flash_fwd_kernel_wgmma" in n) / dev_s,
               "top_kernels_s": sorted(per_kernel.items(),
                                       key=lambda kv: -kv[1])[:6],
               "vs_fp32_plain": {
                   "kernel_path_logits_rel": lrel["bf16", True],
                   "plain_path_logits_rel": lrel["bf16", False],
                   "kernel_path_state_rel": srel["bf16", True],
                   "plain_path_state_rel": srel["bf16", False]},
               "logits_finite": bool(torch.isfinite(
                   logits["bf16", True]).all())},
           "fp32": {
               "flash_launches": launches["fp32", True],
               "kernel_path_s": secs["fp32", True],
               "plain_path_s": secs["fp32", False],
               "kernel_vs_plain_logits_rel": lrel["fp32", True],
               "kernel_vs_plain_state_rel": srel["fp32", True],
               "logits_finite": bool(torch.isfinite(
                   logits["fp32", True]).all())}}
    keep = out["bf16", True]
    del out
    torch.cuda.empty_cache()
    return row, keep


def check_prefills(name, row, n):
    """`n` flash launches of the dtype's route in each kernel-path
    prefill, none on the plain path; fp32 kernel vs plain within LM_TOL
    (logits and the whole cache); the bf16 rule on both."""
    bf, fp = row["bf16"], row["fp32"]
    check(bf["flash_launches"][fa_kernel.BF16_ROUTE] == n
          and sum(bf["flash_launches"].values()) == n,
          f"{name} bf16 prefill launches by route: {bf['flash_launches']}")
    check(fp["flash_launches"][fa_kernel.F32_ROUTE] == n
          and sum(fp["flash_launches"].values()) == n,
          f"{name} fp32 prefill launches by route: {fp['flash_launches']}")
    check(sum(bf["plain_path_launches"].values()) == 0,
          f"{name} plain-path prefill launched a flash kernel")
    check(bf["logits_finite"] and fp["logits_finite"],
          f"{name} prefill logits")
    vs = bf["vs_fp32_plain"]
    for what in ("logits", "state"):
        got, plain = vs[f"kernel_path_{what}_rel"], vs[f"plain_path_{what}_rel"]
        check(got <= BF16_GAP * plain,
              f"{name} bf16 kernel path vs fp32 plain ({what}): {got} > "
              f"{BF16_GAP} x the bf16 plain path's {plain}")
    check(fp["kernel_vs_plain_logits_rel"] <= LM_TOL
          and fp["kernel_vs_plain_state_rel"] <= LM_TOL,
          f"{name} fp32 kernel vs plain: logits "
          f"{fp['kernel_vs_plain_logits_rel']}, state "
          f"{fp['kernel_vs_plain_state_rel']}")


def lm_handoff(cfg, p32, S, cache_len, seed, dev):
    """fp32 at B = 1: prefill(S - 1) (after the prefix, for a prefix
    family) then one decode step, against the forward's last position over
    the prefix and all S tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = random_tokens(seed, (1, S), cfg.vocab_size, dev)
    pe = (synthetic_prefix(gen, cfg, 1, device=dev)
          if cfg.prefix_frontend else None)
    f32 = dict(compute_dtype=torch.float32)
    batch = {"tokens": tok[:, :-1]}
    if pe is not None:
        batch["prefix_embeds"] = pe
    _, state, nxt = make_prefill_step(cfg, cache_len=cache_len,
                                      cache_dtype=torch.float32, device=dev,
                                      **f32)(p32, batch)
    ldec, _ = make_serve_step(cfg, device=dev, **f32)(p32, state, tok[:, -1:],
                                                      nxt)
    del state
    with torch.no_grad():
        full, _, _ = bb.forward(p32, tok, cfg, prefix_embeds=pe, **f32)
    out = {"prefill_len": S - 1, "prefix_len": cfg.prefix_len,
           "decode_pos": int(nxt[0]),
           "decode_vs_forward_logits_rel": rel_dev(ldec[:, 0], full[:, -1]),
           "logits_finite": bool(torch.isfinite(ldec).all())}
    del full
    torch.cuda.empty_cache()
    return out


def lm_decode(cfg, p16, logits, state, nxt, dev):
    """DECODE_STEPS greedy bf16 steps from a prefill's state, eager and
    captured from two copies of it (the same tokens and bitwise the same
    logits), then timed eager runs and a short profiled one, and
    captured_decode's rows, on `state` itself. Returns the row."""
    B = logits.shape[0]
    tok = logits[:, 0].argmax(-1, keepdim=True)
    s_e, s_c = (tree_map(torch.clone, state) for _ in range(2))
    te, le = greedy_run(make_serve_step(cfg, device=dev), p16, s_e, tok,
                        nxt.clone(), DECODE_STEPS)
    cap_step = make_captured_serve_step(cfg, device=dev)
    tc_, lc = greedy_run(cap_step, p16, s_c, tok, nxt.clone(), DECODE_STEPS)
    same_tokens = bool(torch.equal(te, tc_))
    bitwise = all(torch.equal(a, b) for a, b in zip(le, lc))
    finite = all(bool(torch.isfinite(a).all()) for a in le)
    del s_e, s_c, le, lc
    serve_step = make_serve_step(cfg, device=dev)
    pos = nxt + DECODE_STEPS
    tok = te[-1][:, None]

    def decode_run(steps=DECODE_STEPS):
        nonlocal tok, pos
        for _ in range(steps):
            out, _ = serve_step(p16, state, tok, pos)
            tok = out[:, 0].argmax(-1, keepdim=True)
            pos = pos + 1
        return out

    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode_run()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
    prof_wall, per_kernel, kernels, _ = profile_device(
        lambda: decode_run(PROFILE_STEPS))
    busy = sum(per_kernel.values())
    graph = captured_decode(cfg, p16, state, tok, pos, dev)
    return {"batch": B, "steps": DECODE_STEPS, "start_pos": int(nxt[0]),
            "captured_tokens_equal_eager": same_tokens,
            "captured_logits_bitwise_eager": bitwise,
            "logits_finite": finite,
            "eager_decode_tokens_per_s_spread": spread(
                B * DECODE_STEPS / t for t in runs),
            "eager_ms_per_step": statistics.median(runs)
                                 / DECODE_STEPS * 1e3,
            "eager_profiled_device_busy_share": busy / prof_wall,
            "eager_device_ms_per_step": busy / PROFILE_STEPS * 1e3,
            "kernels_per_step": kernels / PROFILE_STEPS,
            "graph": graph}


def check_decode(name, decode):
    check(decode["captured_tokens_equal_eager"]
          and decode["captured_logits_bitwise_eager"]
          and decode["logits_finite"],
          f"{name} captured vs eager decode: tokens "
          f"{decode['captured_tokens_equal_eager']}, logits bitwise "
          f"{decode['captured_logits_bitwise_eager']}, finite "
          f"{decode['logits_finite']}")
    graph = decode["graph"]
    check(graph["vs_eager_logits_rel"] <= GRAPH_TOL and graph["captures"] == 2,
          f"{name} captured decode rows: {graph}")


def lm_server(cfg, p32, dev):
    """BatchedServer in fp32 over 8 requests on 4 slots, eager then
    captured (cold and warm runs)."""
    def requests():
        rng = np.random.default_rng(1)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=rng.integers(4, 12)),
                        max_new=16) for i in range(8)]

    server = BatchedServer(cfg, p32, slots=4, cache_len=256, device=dev,
                           capture=False)
    t1 = time.perf_counter()
    outs = server.serve(requests())
    torch.cuda.synchronize()
    eager_serve_s = time.perf_counter() - t1
    total = sum(len(v) for v in outs.values())
    captured = captured_server_runs(cfg, p32, requests, outs, dev,
                                    cache_len=256)
    del server
    torch.cuda.empty_cache()
    return {"requests": 8, "slots": 4, "cache_len": 256, "max_new": 16,
            "new_tokens": total, "status": sorted(set(outs.status.values())),
            "every_request_16_tokens": all(len(v) == 16
                                           for v in outs.values()),
            "eager_serve_s": eager_serve_s,
            "eager_server_tokens_per_s": total / eager_serve_s,
            "captured": captured}


def check_server(name, server):
    """Every request done with its 16 tokens; the captured server's tokens
    the eager server's, with one graph a slot and one for the batch."""
    captured = server["captured"]
    check(server["status"] == ["done"] and server["every_request_16_tokens"],
          f"{name} server statuses {server['status']}")
    check(captured["tokens_equal_eager"]
          and captured["captures"] == captured["slots"] + 1,
          f"{name} captured server: {captured}")


def bf16_copy(p32):
    """bf16 weights of an fp32 tree; a router (and its bias) stays fp32, as
    a bf16 init keeps it."""
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    moe = p16.get("layers", {}).get("moe")
    if moe is not None:
        for k in ("router", "router_bias"):
            if k in moe:
                moe[k] = p32["layers"]["moe"][k]
    return p16


def phase_granite_moe(dev):
    """granite-moe-1b-a400m at full width and depth (24 layers, d 1024,
    16/8 heads of 64, 32 experts top-8 of width 512, the gspmd dispatch),
    random weights from a seed: the prefills of granite_prefills; 32 bf16
    decode steps at B = 4 from the bf16 prefill, eager and captured (the
    same tokens and bitwise the same logits, from two copies of the
    state), then timed as llama's; BatchedServer in fp32 eager and
    captured; TrainConfig's train steps on plain attention; FedDCL's
    federated round, GRANITE_FED_ROUNDS fedavg rounds of 2 silos x 2
    local steps. Returns the row."""
    cfg = GRANITE
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    p16 = bf16_copy(p32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, (logits, state, nxt) = granite_prefills(cfg, p32, p16, dev)
    decode = lm_decode(cfg, p16, logits, state, nxt, dev)
    del state, logits, p16
    torch.cuda.empty_cache()
    decode["server_fp32"] = lm_server(cfg, p32, dev)
    train = lm_train(cfg, p32, dev, GRANITE_B, GRANITE_S)
    fed = lm_federated(cfg, p32, dev, GRANITE_B, GRANITE_S,
                       GRANITE_FED_ROUNDS)
    row = {"phase": "granite_moe", "arch": cfg.name,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "moe": {"experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                   "d_ff_expert": cfg.moe.d_ff_expert,
                   "impl": cfg.moe.impl,
                   "capacity_factor": cfg.moe.capacity_factor},
           "init_s": init_s, "prefill": prefill, "decode": decode,
           "train": train, "federated": fed}
    emit(row)
    bf, fp = prefill["bf16"], prefill["fp32"]
    n = cfg.num_layers
    check(bf["flash_launches"][fa_kernel.BF16_ROUTE] == n
          and sum(bf["flash_launches"].values()) == n,
          f"granite bf16 prefill launches by route: {bf['flash_launches']}")
    check(fp["flash_launches"][fa_kernel.F32_ROUTE] == n
          and sum(fp["flash_launches"].values()) == n,
          f"granite fp32 prefill launches by route: {fp['flash_launches']}")
    check(sum(bf["plain_path_launches"].values()) == 0,
          "granite plain-path prefill launched a flash kernel")
    check(bf["logits_finite"], "granite bf16 prefill logits")
    vs = bf["vs_fp32_plain"]
    check(vs["kernel_path_cache_rel"]
          <= BF16_GAP * vs["plain_path_cache_rel"],
          f"granite bf16 kernel path vs fp32 plain (the whole KV cache): "
          f"{vs['kernel_path_cache_rel']} > {BF16_GAP} x the bf16 plain "
          f"path's {vs['plain_path_cache_rel']}")
    flips = fp["flips_kernel_vs_plain"]
    check(flips["unexplained"] == 0,
          f"granite fp32 routing flips with a margin >= {FLIP_MARGIN}: "
          f"{flips}")
    check(fp["kernel_vs_plain_logits_rel"] <= LM_TOL or flips["flipped"],
          f"granite fp32 kernel vs plain logits "
          f"{fp['kernel_vs_plain_logits_rel']} with no routing flip")
    check_decode(cfg.name, decode)
    check_server(cfg.name, decode["server_fp32"])
    return row


def lm_batch(cfg, stream, i, B, dev):
    """TokenStream's batch i, with a prefix family's prefix (B, P, d) for
    step i as train() draws it."""
    b = stream.batch(i)
    if cfg.prefix_frontend:
        b["prefix_embeds"] = step_prefix(cfg, 0, i, (B,), dev)
    return b


def lm_train(cfg, p32, dev, B, S, *, steps=TRAIN_STEPS, in_place=False,
             opt_state_dtype="float32"):
    """`steps` of make_train_step at TrainConfig's defaults (fp32 params,
    bf16 compute, AdamW with `opt_state_dtype` moments, remat) on B x S
    tokens (after a prefix family's prefix), on plain attention, as
    train() runs every family but ssm, from a copy of `p32` (`in_place`:
    on `p32` itself, which the steps then train)."""
    tc = TrainConfig(model=cfg, shape=InputShape("chip", S, B, "train"),
                     warmup_steps=2, total_steps=steps,
                     opt_state_dtype=opt_state_dtype)
    params = p32 if in_place else tree_map(torch.clone, p32)
    step, opt = make_train_step(cfg, tc, use_kernels=False, device=dev)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    stream = TokenStream(cfg.vocab_size, S, B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_launches()
    metrics, step_s = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state,
                                    lm_batch(cfg, stream, i, B, dev))
        metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last = lm_batch(cfg, stream, steps, B, dev)
    wall, per_kernel, kernels, _ = profile_device(
        lambda: step(params, opt_state, last))
    dev_s = sum(per_kernel.values())
    steady = statistics.median(step_s[1:])
    row = {"train_config": {"param_dtype": tc.param_dtype,
                            "compute_dtype": tc.compute_dtype,
                            "opt_state_dtype": tc.opt_state_dtype,
                            "remat": tc.remat, "use_kernels": False},
           "batch": B, "seq": S, "prefix_len": cfg.prefix_len,
           "steps": steps,
           "params_and_opt_state_gb": state_gb,
           "max_memory_allocated_gb": peak_gb, "metrics": metrics,
           "step_s": step_s, "steady_step_s_spread": spread(step_s[1:]),
           "train_tokens_per_s": B * S / steady,
           "flash_launches": fa_kernel.launches(),
           "profiled_step_wall_s": wall, "profiled_device_s": dev_s,
           "device_busy_share": dev_s / wall, "kernels_per_step": kernels,
           "top_kernels_s": sorted(per_kernel.items(),
                                   key=lambda kv: -kv[1])[:6]}
    del params, opt_state
    torch.cuda.empty_cache()
    check(all(bool(np.isfinite(list(m.values())).all()) for m in metrics),
          f"{cfg.name} train metrics {metrics}")
    check(row["flash_launches"] == 0, f"{cfg.name} training launched flash")
    return row


def lm_federated(cfg, p32, dev, B, S, rounds, *, opt_state_dtype="float32",
                 release=False):
    """FedDCL's launch tier at full width: 2 silos x 2 local steps a
    round, B x S tokens a step split over the silos (a prefix family's
    prefix per silo too, as train() draws it), fedavg with AdamW's moments
    in `opt_state_dtype`, `rounds` rounds from `p32` stacked per silo: the
    first as its local phase then the sync (the silos compared between),
    the rest through make_federated_round_step. `release` empties the
    caller's `p32` dict once the stack is made, so its tensors are freed
    before the moments are."""
    d, h, b = 2, 2, B // 2
    fed = FederatedConfig(num_silos=d, local_steps=h)
    tc = TrainConfig(model=cfg, shape=InputShape("chip", S, B, "train"),
                     federated=fed, warmup_steps=2, total_steps=rounds * h,
                     opt_state_dtype=opt_state_dtype)
    kw = dict(use_kernels=False, device=dev)
    phase, opt = make_federated_local_phase_step(cfg, tc, **kw)
    round_step, _ = make_federated_round_step(cfg, tc, **kw)
    sync = make_fedavg_sync_step(tc, device=dev)
    sp = tree_map(lambda a: a.contiguous(), silo_replicate(p32, d))
    if release:
        p32.clear()
        torch.cuda.empty_cache()
    so = silo_opt_init(opt, sp)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9

    def batches(r):
        out = [silo_batches(cfg.vocab_size, S, b, d, r * h + i, seed=0)
               for i in range(h)]
        bs = {k: np.stack([o[k] for o in out]) for k in out[0]}
        if cfg.prefix_frontend:
            bs["prefix_embeds"] = torch.stack([
                step_prefix(cfg, 0, r * h + i, (d, b), dev)
                for i in range(h)])
        return bs

    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_launches()
    losses, moe_aux, round_s, equal = [], [], [], []
    for r in range(rounds):
        bs = batches(r)
        # feddcl-lint: disable=R008  each round is timed alone: the sync bounds its measurement
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if r == 0:
            sp, so, m = phase(sp, so, bs)
            parted = not silos_equal(sp)
            sp, so = sync(sp, so)
        else:
            sp, so, m = round_step(sp, so, bs)
        # feddcl-lint: disable=R008  each round is timed alone: the sync bounds its measurement
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        equal.append(silos_equal(sp))
        # feddcl-lint: disable=R008  the round was synced above: the phase reads each round's loss and aux after it
        losses.append(m["loss"].tolist())
        if "moe_aux" in m:
            # feddcl-lint: disable=R008  as the loss above, after the round's sync
            moe_aux.append(m["moe_aux"].tolist())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(round_s)
    row = {"silos": d, "local_steps": h, "per_silo_batch": b,
           "seq": S, "prefix_len": cfg.prefix_len, "rounds": rounds,
           "aggregator": fed.aggregator, "opt_state_dtype": tc.opt_state_dtype,
           "stacked_params_and_opt_state_gb": state_gb,
           "max_memory_allocated_gb": peak_gb, "round_s": round_s,
           "round_s_spread": spread(round_s),
           "federated_train_tokens_per_s": d * h * b * S / med,
           "losses": losses, **({"moe_aux": moe_aux} if moe_aux else {}),
           "silos_parted_before_first_sync": parted,
           "silos_bitwise_equal_after_each_sync": equal,
           "flash_launches": fa_kernel.launches()}
    del sp, so
    torch.cuda.empty_cache()
    check(bool(np.isfinite(losses).all()),
          f"{cfg.name} federated losses {losses}")
    check(parted and all(equal),
          f"{cfg.name} silos: parted {parted}, equal after each sync {equal}")
    check(row["flash_launches"] == 0, f"{cfg.name} federated training "
                                      "launched flash")
    return row


# -- phase 14: zamba2-1.2b, the hybrid family ---------------------------------

@contextlib.contextmanager
def ssd_timer():
    """Time every ssd_chunked call (the SSD scan of each Mamba2 block) by
    CUDA events around it while the block runs: [(start, end)], read
    after a synchronize."""
    events = []
    real = model_layers.ssd_chunked

    def timed(*args, **kw):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        out = real(*args, **kw)
        e.record()
        events.append((s, e))
        return out

    model_layers.ssd_chunked = timed
    try:
        yield events
    finally:
        model_layers.ssd_chunked = real


def zamba2_prefills(cfg, p32, p16, dev):
    """lm_prefills of ZAMBA_B x ZAMBA_S, then the bf16 kernel path once
    more with its SSD scans timed by CUDA events, against the profiled
    device time. Returns (row, the bf16 kernel path's logits, state and
    next position)."""
    row, keep = lm_prefills(cfg, p32, p16, ZAMBA_B, ZAMBA_S, ZAMBA_CACHE,
                            17, dev)
    step = make_prefill_step(cfg, cache_len=ZAMBA_CACHE, device=dev)
    tokens = {"tokens": random_tokens(17, (ZAMBA_B, ZAMBA_S),
                                      cfg.vocab_size, dev)}
    with ssd_timer() as ssd_events:
        step(p16, tokens)
    torch.cuda.synchronize()
    ssd_s = sum(s.elapsed_time(e) for s, e in ssd_events) / 1e3
    bf = row["bf16"]
    bf.update(ssd_calls=len(ssd_events), ssd_event_s=ssd_s,
              ssd_share_of_device_time=ssd_s / bf["profiled_device_s"])
    return row, keep


def zamba2_reuse(cfg, p32, dev):
    """ZAMBA_REUSE_REQUESTS requests served in turn through one slot of a
    captured server, each against a fresh captured server serving it
    alone: admission zeroes the slot's Mamba2 states."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
               for _ in range(ZAMBA_REUSE_REQUESTS)]
    reqs = lambda: [Request(rid=i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)]
    kw = dict(slots=1, cache_len=256, device=dev)
    reused = BatchedServer(cfg, p32, **kw).serve(reqs())
    alone = {}
    for r in reqs():
        alone.update(BatchedServer(cfg, p32, **kw).serve([r]))
    return {"requests": ZAMBA_REUSE_REQUESTS, "slots": 1, "max_new": 8,
            "reused_slot_equals_fresh_server": dict(reused) == alone,
            "status": sorted(set(reused.status.values()))}


def phase_zamba2_hybrid(dev):
    """zamba2-1.2b at full width and depth (38 Mamba2 blocks: 6 rounds of
    6, each followed by the one weight-shared attention + SwiGLU block,
    32/32 heads of 64, then 2 trailing blocks; d 2048, SSD 64 heads of 64,
    state 64, chunk 128; vocab 32,000, untied), random weights from a
    seed: the prefills of zamba2_prefills; the fp32 handoff of
    lm_handoff; 32 bf16 decode steps at B = 4 from the bf16 prefill,
    eager and captured (the same tokens and bitwise the same logits, from
    two copies of the state), then timed as llama's; BatchedServer in fp32
    eager and captured, and a reused slot against fresh servers;
    TrainConfig's train steps on plain attention; FedDCL's federated
    round, ZAMBA_FED_ROUNDS fedavg rounds of 2 silos x 2 local steps.
    Returns the row."""
    cfg = ZAMBA
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    # bf16 weights; A_log, D and dt_bias stay fp32, as a bf16 init keeps them
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    for k in ("A_log", "D", "dt_bias"):
        for part in ("layers", "tail_layers"):
            p16[part]["mamba"][k] = p32[part]["mamba"][k]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, (logits, state, nxt) = zamba2_prefills(cfg, p32, p16, dev)
    # the last SSD chunk of prefill(S - 1) is padded
    handoff = lm_handoff(cfg, p32, ZAMBA_S, ZAMBA_CACHE, 18, dev)
    decode = lm_decode(cfg, p16, logits, state, nxt, dev)
    del state, logits, p16
    torch.cuda.empty_cache()
    decode["server_fp32"] = lm_server(cfg, p32, dev)
    decode["server_fp32"]["slot_reuse"] = reuse = zamba2_reuse(cfg, p32, dev)
    torch.cuda.empty_cache()
    train = lm_train(cfg, p32, dev, ZAMBA_B, ZAMBA_S)
    fed = lm_federated(cfg, p32, dev, ZAMBA_B, ZAMBA_S, ZAMBA_FED_ROUNDS)
    rounds = cfg.num_layers // cfg.hybrid_period
    row = {"phase": "zamba2_hybrid", "arch": cfg.name,
           "params": cfg.param_count(),
           "hybrid": {"mamba2_blocks": cfg.num_layers,
                      "period": cfg.hybrid_period,
                      "shared_applications": rounds,
                      "trailing": cfg.num_layers - rounds * cfg.hybrid_period,
                      "ssd_heads": cfg.ssm.expand * cfg.d_model
                                   // cfg.ssm.head_dim,
                      "state": cfg.ssm.state_dim, "chunk": cfg.ssm.chunk},
           "init_s": init_s, "prefill": prefill, "handoff_fp32": handoff,
           "decode": decode, "train": train, "federated": fed}
    emit(row)
    check_prefills("zamba2", prefill, rounds)
    check(prefill["bf16"]["ssd_calls"] == cfg.num_layers,
          f"zamba2 bf16 prefill: {prefill['bf16']['ssd_calls']} SSD scans")
    check(handoff["logits_finite"]
          and handoff["decode_vs_forward_logits_rel"] <= LM_TOL,
          f"zamba2 fp32 prefill(S-1) + decode vs forward: {handoff}")
    check_decode(cfg.name, decode)
    check_server(cfg.name, decode["server_fp32"])
    check(reuse["reused_slot_equals_fresh_server"]
          and reuse["status"] == ["done"],
          f"zamba2 reused slot vs fresh servers: {reuse}")
    return row


# -- phases 15-17: the prefix families and MLA --------------------------------

def phase_musicgen_audio(dev):
    """musicgen-large at full width and depth (48 layers, d 2048, MHA
    32/32 heads of 64, d_ff 8192, vocab 2048, prefix 64), random weights
    from a seed: lm_prefills (T = 2112: a ragged last key tile, the prefix
    on the key axis), the fp32 handoff, a bf16 decode eager and captured,
    BatchedServer (served from tokens alone, as the reference's server
    serves a prefix family), TrainConfig's train steps on plain attention
    (on the phase's own params, which they train) and FedDCL's federated
    rounds from the trained params with bf16 moments. Returns the row."""
    cfg = MUSICGEN
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    p16 = bf16_copy(p32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cache_len = cfg.prefix_len + MUSICGEN_S + DECODE_ROOM
    prefill, (logits, state, nxt) = lm_prefills(
        cfg, p32, p16, MUSICGEN_B, MUSICGEN_S, cache_len, 23, dev)
    handoff = lm_handoff(cfg, p32, MUSICGEN_S, cache_len, 24, dev)
    decode = lm_decode(cfg, p16, logits, state, nxt, dev)
    del logits, state, p16
    torch.cuda.empty_cache()
    decode["server_fp32"] = lm_server(cfg, p32, dev)
    train = lm_train(cfg, p32, dev, MUSICGEN_TRAIN_B, MUSICGEN_TRAIN_S,
                     in_place=True)
    fed = lm_federated(cfg, p32, dev, MUSICGEN_FED_B, MUSICGEN_TRAIN_S,
                       MUSICGEN_FED_ROUNDS, opt_state_dtype="bfloat16",
                       release=True)
    del p32
    torch.cuda.empty_cache()
    row = {"phase": "musicgen_audio", "arch": cfg.name,
           "params": cfg.param_count(), "layers": cfg.num_layers,
           "init_s": init_s, "prefill": prefill, "handoff_fp32": handoff,
           "decode": decode, "train": train, "federated": fed}
    emit(row)
    check_prefills(cfg.name, prefill, cfg.num_layers)
    check(prefill["next_pos"] == [cfg.prefix_len + MUSICGEN_S],
          f"musicgen next position {prefill['next_pos']}")
    check(handoff["logits_finite"]
          and handoff["decode_vs_forward_logits_rel"] <= LM_TOL,
          f"musicgen fp32 prefill(S-1) + decode vs forward: {handoff}")
    check_decode(cfg.name, decode)
    check_server(cfg.name, decode["server_fp32"])
    return row


def phase_chameleon_vlm(dev):
    """chameleon-34b at full width (d 8192, GQA 64/8 heads of 128 with
    qk-norm, d_ff 22016, vocab 65536, prefix 256), depth cut to 8 layers,
    random weights from a seed: lm_prefills (T = 2304, hd 128 at GQA 8:1),
    the fp32 handoff, a bf16 decode at B = 2 eager and captured. Returns
    the row."""
    cfg = CHAMELEON
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    p16 = bf16_copy(p32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cache_len = cfg.prefix_len + CHAMELEON_S + DECODE_ROOM
    prefill, (logits, state, nxt) = lm_prefills(
        cfg, p32, p16, CHAMELEON_B, CHAMELEON_S, cache_len, 31, dev)
    handoff = lm_handoff(cfg, p32, CHAMELEON_S, cache_len, 32, dev)
    del p32
    torch.cuda.empty_cache()
    decode = lm_decode(cfg, p16, logits, state, nxt, dev)
    del logits, state, p16
    torch.cuda.empty_cache()
    row = {"phase": "chameleon_vlm", "arch": cfg.name,
           "params": cfg.param_count(), "layers": cfg.num_layers,
           "layers_published": ARCHS["chameleon-34b"].num_layers,
           "qk_norm": cfg.qk_norm, "init_s": init_s, "prefill": prefill,
           "handoff_fp32": handoff, "decode": decode}
    emit(row)
    check_prefills(cfg.name, prefill, cfg.num_layers)
    check(prefill["next_pos"] == [cfg.prefix_len + CHAMELEON_S],
          f"chameleon next position {prefill['next_pos']}")
    check(handoff["logits_finite"]
          and handoff["decode_vs_forward_logits_rel"] <= LM_TOL,
          f"chameleon fp32 prefill(S-1) + decode vs forward: {handoff}")
    check_decode(cfg.name, decode)
    return row


def phase_deepseek_mla(dev):
    """deepseek-v3 at full width (d 7168, 128 heads; MLA ranks q 1536 /
    kv 512, nope / rope / v 128 / 64 / 128; d_ff 18432, experts of 2048
    top-8 with the sigmoid router and one shared expert; MTP depth 1;
    vocab 129,280), cut to 2 layers and 32 experts, random weights from a
    seed: a bf16 prefill (no flash launch: MLA's expanded form takes
    ``sdpa``, as the reference's does), a bf16 decode on the latent cache
    eager and captured, the fp32 handoff (the absorbed decode against the
    expanded forward, at a capacity where the forward drops no pair: the
    gspmd dispatch takes its capacity from each call's token count, so at
    1.25 the 2048-token forward may drop pairs the one-token decode
    keeps, the reference's behaviour), and TrainConfig's train steps with
    MTP, bf16 moments. Returns the row."""
    cfg = DEEPSEEK
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(37)
    p32 = bb.init_params(cfg, gen, torch.float32, device=dev)
    p16 = bf16_copy(p32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cache_len = DEEPSEEK_S + DECODE_ROOM
    batch = {"tokens": random_tokens(41, (DEEPSEEK_B, DEEPSEEK_S),
                                     cfg.vocab_size, dev)}
    prefill_step = make_prefill_step(cfg, cache_len=cache_len, device=dev)
    fa_kernel.reset_launches()
    logits, state, nxt = prefill_step(p16, batch)
    torch.cuda.synchronize()
    launches = dict(fa_kernel.route_launches)
    prefill_s = wall_s(lambda: prefill_step(p16, batch), reps=3)
    _, per_kernel, kernels, _ = profile_device(
        lambda: prefill_step(p16, batch))
    dev_s = sum(per_kernel.values())
    m = cfg.mla
    prefill = {"batch": DEEPSEEK_B, "seq": DEEPSEEK_S, "cache_len": cache_len,
               "flash_launches": launches, "prefill_s": prefill_s,
               "prefill_tokens_per_s": DEEPSEEK_B * DEEPSEEK_S / prefill_s,
               "profiled_device_s": dev_s, "kernels": kernels,
               "top_kernels_s": sorted(per_kernel.items(),
                                       key=lambda kv: -kv[1])[:6],
               "latent_cache_numbers_per_position": m.kv_lora_rank
                                                    + m.qk_rope_head_dim,
               "kv_cache_numbers_per_position_expanded":
                   2 * cfg.num_heads * m.v_head_dim,
               "state_leaves": {part: sorted(state[part]) for part in state},
               "logits_finite": bool(torch.isfinite(logits).all())}
    mo = cfg.moe
    no_drop = cfg.with_overrides(moe=replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    handoff = lm_handoff(no_drop, p32, DEEPSEEK_S, cache_len, 42, dev)
    handoff["capacity_factor"] = no_drop.moe.capacity_factor
    decode = lm_decode(cfg, p16, logits, state, nxt, dev)
    del logits, state, p16
    torch.cuda.empty_cache()
    train = lm_train(cfg, p32, dev, DEEPSEEK_TRAIN_B, DEEPSEEK_TRAIN_S,
                     steps=DEEPSEEK_TRAIN_STEPS, in_place=True,
                     opt_state_dtype="bfloat16")
    del p32
    torch.cuda.empty_cache()
    row = {"phase": "deepseek_mla", "arch": cfg.name,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "cut": {"layers": [cfg.num_layers,
                              ARCHS["deepseek-v3-671b"].num_layers],
                   "experts": [mo.num_experts,
                               ARCHS["deepseek-v3-671b"].moe.num_experts]},
           "init_s": init_s, "prefill": prefill, "handoff_fp32": handoff,
           "decode": decode, "train": train}
    emit(row)
    check(sum(launches.values()) == 0,
          f"deepseek MLA prefill launched flash: {launches}")
    check(prefill["logits_finite"], "deepseek bf16 prefill logits")
    check(prefill["state_leaves"] == {
        "dense_cache": ["ckv", "krope", "pos"],
        "cache": ["ckv", "krope", "pos"]},
          f"deepseek decode state {prefill['state_leaves']}")
    check(handoff["logits_finite"]
          and handoff["decode_vs_forward_logits_rel"] <= LM_TOL,
          f"deepseek fp32 prefill(S-1) + absorbed decode vs forward: "
          f"{handoff}")
    check_decode(cfg.name, decode)
    check(all("mtp" in mm for mm in train["metrics"]),
          "deepseek train metrics without the MTP loss")
    return row


def dryrun_check(name, step, meta_args, real_args, dev):
    """`step` traced on fake tensors of `dev` from `meta_args` (the
    dry-run's counters), then run for real on `real_args` under the same
    counters from a reset peak: the fake vs real flops (equal), the
    trace's peak against the allocator's (the step's own allocations
    plus its arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode():
        _, est = dryrun.trace_step(step, dryrun.fake_args(meta_args, dev))
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    t0 = time.perf_counter()
    out, real = dryrun.trace_step(step, real_args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    args_b = est["memory"]["argument_bytes"]
    measured = torch.cuda.max_memory_allocated() - base + args_b
    # the sizes the step asked for, before the allocator's blocks round them
    requested = torch.cuda.memory_stats()["requested_bytes.all.peak"] \
        - base_req + args_b
    del out
    row = {"step": name, "trace_s": trace_s, "run_s": run_s,
           "flops_fake": est["flops"], "flops_real": real["flops"],
           "bytes_accessed_fake": est["bytes_accessed"],
           "bytes_accessed_real": real["bytes_accessed"],
           "estimated_peak_bytes": est["peak_bytes"],
           "counted_peak_bytes_real": real["peak_bytes"],
           "measured_peak_bytes": measured,
           "requested_peak_bytes": requested,
           "peak_ratio": est["peak_bytes"] / measured,
           "requested_ratio": est["peak_bytes"] / requested,
           "temp_ratio": (est["peak_bytes"]
                          - est["memory"]["argument_bytes"])
           / (measured - est["memory"]["argument_bytes"]),
           "memory": est["memory"]}
    check(row["flops_fake"] == row["flops_real"] > 0,
          f"dryrun {name}: fake flops {row['flops_fake']} != real "
          f"{row['flops_real']}")
    lo, hi = DRYRUN_PEAK
    check(lo <= row["peak_ratio"] <= hi,
          f"dryrun {name}: estimated / measured peak {row['peak_ratio']} "
          f"outside {DRYRUN_PEAK}")
    return row


def phase_dryrun(dev):
    """The dry-run's one-card counters (``launch.dryrun``) on two runs the
    card makes: llama3.2-1b's bf16 prefill of PREFILL_B x PREFILL_S on the
    plain path, and a granite-moe-1b train step of GRANITE_B x GRANITE_S
    (TrainConfig's defaults, plain attention), random weights from a seed;
    then ``python -m repro_torch.launch.dryrun`` on the card for two
    pairs. Fails when the flops differ or a peak ratio leaves
    DRYRUN_PEAK."""
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    check(total == roofline.HW["hbm_bytes"],
          f"total_memory {total} != roofline.HW {roofline.HW['hbm_bytes']}")
    meta = torch.device("meta")
    rows = []
    step = make_prefill_step(LLAMA, cache_len=PREFILL_CACHE,
                             compute_dtype=torch.bfloat16,
                             use_kernels=False, device=dev)
    p16 = bb.init_params(LLAMA, torch.Generator(device=dev).manual_seed(3),
                         torch.bfloat16, device=dev)
    tokens = random_tokens(4, (PREFILL_B, PREFILL_S), LLAMA.vocab_size, dev)
    meta_args = (bb.init_params(LLAMA, None, torch.bfloat16, device=meta),
                 {"tokens": torch.empty((PREFILL_B, PREFILL_S),
                                        dtype=tokens.dtype, device=meta)})
    rows.append(dryrun_check("llama3.2-1b bf16 prefill plain", step,
                             meta_args, (p16, {"tokens": tokens}), dev))
    del p16
    torch.cuda.empty_cache()
    tc = TrainConfig(model=GRANITE, shape=InputShape(
        "chip", GRANITE_S, GRANITE_B, "train"))
    step, opt = make_train_step(GRANITE, tc, use_kernels=False, device=dev)
    p32 = bb.init_params(GRANITE, torch.Generator(device=dev).manual_seed(7),
                         torch.float32, device=dev)
    batch = TokenStream(GRANITE.vocab_size, GRANITE_S, GRANITE_B,
                        seed=0).batch(0)
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batch.items()}
    pm = bb.init_params(GRANITE, None, torch.float32, device=meta)
    meta_args = (pm, opt.init(pm), {k: torch.empty(v.shape, dtype=v.dtype,
                                                   device=meta)
                                    for k, v in batch.items()})
    rows.append(dryrun_check("granite-moe-1b train step", step, meta_args,
                             (p32, opt.init(p32), batch), dev))
    del p32
    torch.cuda.empty_cache()
    # the CLI on the card: fake cuda tensors, one traced and one spec-level
    # pair, its records read back from a temporary directory
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                          "--out", out])
        rc |= dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                           "--multi-pod", "--out", out])
        recs = roofline_table.load(out)
    cli_s = time.perf_counter() - t0
    rec = recs[("llama3.2-1b", "decode_32k", "1x1", "baseline")]
    row = {"phase": "dryrun", "checks": rows, "total_memory": total,
           "cli_s": cli_s, "cli_decode_32k": {
               k: rec[k] for k in ("flops_per_device", "bytes_per_device",
                                   "peak_bytes", "fits_one_card",
                                   "dominant", "roofline_bound_s")},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(rc == 0, f"dryrun CLI exit {rc}")
    return row


def ep_case(dev):
    """Layer 0's MoE params of granite-moe-1b at full width (random from a
    seed, fp32, NumPy), the block x and the cotangent."""
    cfg = GRANITE.with_overrides(moe=replace(GRANITE.moe, impl="ep"))
    gen = torch.Generator(device=dev).manual_seed(11)
    p = model_layers.init_moe(gen, cfg, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=g, device=dev)
    cot = torch.randn((EP_B, EP_S, cfg.d_model), generator=g, device=dev)
    return cfg, p, x, cot


def phase_moe_ep(dev, smi):
    """The expert-parallel exchange (``models.moe_ep``) on EP_RANKS ranks
    sharing the card: one granite-moe-1b MoE layer at full width, a
    (1, EP_RANKS) mesh, forward and backward of sum(out · cot) + EP_AUX ·
    aux (each rank's share: its own S/M slice), in fp32; held to the plain
    one-process emulation of the exchange (the M shards' buffers
    concatenated, ``moe_ep.emulate_ep``) and its autograd, within EP_TOL;
    the exchange's bytes and ms a layer."""
    t_phase = time.perf_counter()
    cfg, p, x, cot = ep_case(dev)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    out, aux = moe_ep.emulate_ep(p, xg, cfg, EP_RANKS)
    loss = torch.sum(out * cot) + EP_AUX * aux
    grads = torch.autograd.grad(loss, leaves + [xg], allow_unused=True)
    want = {"out": out.detach().cpu().numpy(), "aux": float(aux.detach())}
    names = [k for k in p] + ["x"]
    want_g = {k: (np.zeros(tuple(t.shape), np.float32) if g is None
                  else g.cpu().numpy())
              for k, t, g in zip(names, leaves + [xg], grads)}
    spec = {"meshes": [(1, EP_RANKS)], "device": dev.type,
            "repeats": EP_REPEATS,
            "cases": [{"name": "granite", "cfg": cfg,
                       "params": mlp_params_to_numpy(p),
                       "x": x.cpu().numpy(), "cot": cot.cpu().numpy(),
                       "aux_coef": EP_AUX}]}
    del out, aux, grads, loss, xg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = run_ranks(fed_ranks.moe_ep_layer, EP_RANKS, args=(spec,),
                    device=dev.type, timeout=600)
    ranks_s = time.perf_counter() - t0
    res = [g[((1, EP_RANKS), "granite")] for g in got]
    scale = lambda a: max(1.0, float(np.abs(a).max()))  # noqa: E731
    out_gap = max(float(np.abs(r["out"] - want["out"]).max())
                  for r in res) / scale(want["out"])
    aux_gap = max(abs(r["aux"] - want["aux"]) for r in res) \
        / scale(np.asarray(want["aux"]))
    grad_gaps = {}
    for k in names:
        summed = sum(r["grads"][k] for r in res)
        grad_gaps[k] = float(np.abs(summed - want_g[k]).max()) \
            / scale(want_g[k])
    mo = cfg.moe
    T_loc = EP_B * EP_S // EP_RANKS
    cap = max(int(mo.capacity_factor * T_loc * mo.top_k / mo.num_experts), 1)
    buf_bytes = mo.num_experts * cap * cfg.d_model * 4
    row = {"phase": "moe_ep", "arch": cfg.name, "ranks": EP_RANKS,
           "mesh": [1, EP_RANKS], "tokens": [EP_B, EP_S],
           "experts": mo.num_experts, "top_k": mo.top_k,
           "d_model": cfg.d_model, "T_loc": T_loc, "cap": cap,
           "buffer_bytes_each_way": buf_bytes,
           "crossing_bytes_each_way": buf_bytes * (EP_RANKS - 1) // EP_RANKS,
           "out_gap": out_gap, "aux_gap": aux_gap, "grad_gaps": grad_gaps,
           "exchange_by_rank": [r["stats"] for r in res],
           "layer_ms_by_rank": [1e3 * r["seconds"] for r in res],
           "collective_ms_by_rank": [1e3 * r["stats"]["seconds"]
                                     for r in res],
           "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
           "device": smi}
    emit(row)
    check(out_gap <= EP_TOL and aux_gap <= EP_TOL,
          f"moe_ep out {out_gap} / aux {aux_gap} vs the emulation")
    check(max(grad_gaps.values()) <= EP_TOL,
          f"moe_ep summed gradients vs the emulation's: {grad_gaps}")
    check(all(r["stats"]["calls"]["all_to_all"] == 4 for r in res),
          f"moe_ep exchanges: {[r['stats'] for r in res]}")
    return row


def phase_sharded_llm(dev, smi):
    """The sharded LLM program on ranks of one card (module docstring):
    the gloo probe, then llama3.2-1b's checked loss and gradient, its
    timed train steps and granite's EP layer, one group of SLLM_RANKS
    ranks."""
    t_phase = time.perf_counter()
    def probe_group(names):
        try:
            got = run_ranks(llm_ranks.gloo_probe, 2, args=(names,),
                            device=dev.type, backend="gloo", timeout=120)
            return got[0] if got[0] == got[1] else {n: got for n in names}
        except (RankError, TimeoutError) as e:
            return {n: f"{type(e).__name__}: {str(e).splitlines()[-1]}"
                    for n in names}

    # gloo's CUDA all_gather_into_tensor ends its process (torch 2.11):
    # it runs in a group of its own, beside one group for the others
    alone = ("all_gather_into_tensor",)
    groups = [alone, tuple(n for n in llm_ranks.PROBED if n not in alone)]
    with ThreadPoolExecutor(len(groups)) as pool:
        got = {k: v for g in pool.map(probe_group, groups)
               for k, v in g.items()}
    probe = {n: got[n] for n in llm_ranks.PROBED}
    emit({"phase": "sharded_llm.gloo_probe", "cuda_tensors_on_gloo": probe,
          "probe_s": time.perf_counter() - t_phase, "device": smi})
    torch.cuda.empty_cache()
    spec = {"mesh": SLLM_MESH, "check": SLLM_CHECK,
            "check_tc": SLLM_CHECK_TC, "train": SLLM_TRAIN,
            "steps": SLLM_STEPS, "compute_dtype": "bfloat16",
            "ep": SLLM_EP, "ep_repeats": SLLM_EP_REPEATS}
    t0 = time.perf_counter()
    res = run_ranks(llm_ranks.card_llama, SLLM_RANKS, args=(spec,),
                    device=dev.type, backend="staged", timeout=900)
    ranks_s = time.perf_counter() - t0
    r0 = res[0]
    steps = [[st for st in r["steps"]] for r in res]
    row = {"phase": "sharded_llm", "arch": "llama3.2-1b",
           "ranks": SLLM_RANKS, "mesh": list(SLLM_MESH),
           "check_tokens": list(SLLM_CHECK),
           "loss_unsharded": r0["loss_unsharded"],
           "loss_sharded": r0["loss_sharded"], "loss_gap": r0["loss_gap"],
           "grad_gap": r0["grad_gap"],
           "check_s_by_rank": [r["check_s"] for r in res],
           "step_loss_gap": r0["step_loss_gap"],
           "step_param_gap": r0["step_param_gap"],
           "step_update_gap": r0["step_update_gap"],
           "step_check_s_by_rank": [r["step_check_s"] for r in res],
           "check_collectives_rank0": r0["check_collectives"],
           "train_tokens": list(SLLM_TRAIN), "compute_dtype": "bfloat16",
           "step_s_by_rank": [[st["s"] for st in s_] for s_ in steps],
           "losses": [st["loss"] for st in steps[0]],
           "collective_ms_by_rank": [[1e3 * st["collectives"]["seconds"]
                                      for st in s_] for s_ in steps],
           "staged_bytes_by_rank": [[st["collectives"]["staged_bytes"]
                                     for st in s_] for s_ in steps],
           "wire_bytes_by_rank": [[st["collectives"]["wire_bytes"]
                                   for st in s_] for s_ in steps],
           "calls_rank0": [st["collectives"]["calls"] for st in steps[0]],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in res],
           "ep_tokens": list(SLLM_EP),
           "ep_ms_by_rank": [[1e3 * t for t in r["ep_s"]] for r in res],
           "ep_collectives_rank0": r0["ep_collectives"],
           "ep_out_gap": r0["ep_out_gap"], "ep_aux_gap": r0["ep_aux_gap"],
           "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
           "device": smi}
    emit(row)
    check(r0["loss_gap"] <= SLLM_LOSS_TOL,
          f"sharded llama loss gap {r0['loss_gap']}")
    check(r0["grad_gap"] <= SLLM_GRAD_TOL,
          f"sharded llama gradient gap {r0['grad_gap']}")
    check(r0["step_loss_gap"] <= SLLM_LOSS_TOL
          and r0["step_param_gap"] <= SLLM_STEP_TOL,
          f"sharded llama fp32 train step: loss gap {r0['step_loss_gap']}, "
          f"params {r0['step_param_gap']} after it")
    check(all(np.isfinite(st["loss"]) for s_ in steps for st in s_),
          "sharded llama train losses finite")
    check(r0["ep_out_gap"] <= EP_TOL and r0["ep_aux_gap"] <= EP_TOL,
          f"sharded EP layer out {r0['ep_out_gap']} / aux "
          f"{r0['ep_aux_gap']} vs the per-block emulation")
    check(all(r["check_collectives"]["wire_bytes"] > 0 for r in res),
          "the sharded step moved nothing between ranks")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmul precision must be 'highest'")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls must be off")
    dev = torch.device("cuda:0")
    smi = phase_device()
    peak = peaks_for(smi)
    rows = phase_kernel_check(peak)
    model, data, fit_row = phase_fit(dev)
    serve_row = phase_serve_collab(dev, model, data)
    torch.cuda.empty_cache()
    phase_scan_timing(dev, model, fit_row)
    phase_fit_host(dev, data)
    phase_step4_profile(model)
    phase_scan_vs_host(dev, model)
    phase_device_vs_host(model, data)
    del model, data
    clear_plan_cache()
    paper_row = phase_paper_experiments(dev)
    clear_plan_cache()
    phase_bar_drivers(dev)
    clear_plan_cache()
    phase_audit(dev, smi)
    clear_plan_cache()
    phase_sharded(dev, smi)
    clear_plan_cache()
    flash_rows = phase_flash_check(dev, peak)
    p32, p16, logits, state, nxt, prefill_row = phase_llm_prefill(dev)
    phase_llm_decode(dev, p32, p16, logits, state, nxt)
    del p32, p16, logits, state, nxt
    torch.cuda.empty_cache()
    gemma_row = phase_gemma2_prefill(dev)
    torch.cuda.empty_cache()
    granite_row = phase_granite_moe(dev)
    torch.cuda.empty_cache()
    phase_dryrun(dev)
    torch.cuda.empty_cache()
    phase_moe_ep(dev, smi)
    torch.cuda.empty_cache()
    phase_sharded_llm(dev, smi)
    torch.cuda.empty_cache()
    zamba_row = phase_zamba2_hybrid(dev)
    torch.cuda.empty_cache()
    musicgen_row = phase_musicgen_audio(dev)
    torch.cuda.empty_cache()
    chameleon_row = phase_chameleon_vlm(dev)
    torch.cuda.empty_cache()
    phase_deepseek_mla(dev)
    torch.cuda.empty_cache()
    wkv_rows = phase_wkv6_check(dev, peak)
    train_row, rwkv_params = phase_rwkv6_train(dev, wkv_rows[0])
    rwkv_serve_row = phase_rwkv6_serve(dev, rwkv_params)
    # the federated phase's silo stack owns its storage (the steps write
    # each silo's slice in place); the trained params go before its
    # optimizer state is made
    sp = tree_map(lambda a: a.contiguous(), silo_replicate(rwkv_params, FED_D))
    del rwkv_params
    torch.cuda.empty_cache()
    fed_row = phase_rwkv6_federated(dev, sp, train_row)
    del sp
    main_rows = rows[:len(MAIN_SHAPES)]

    def per_fit(key):
        return sum(n * r[key] for n, r in zip(MAIN_COUNTS, main_rows))

    # the bf16 flash kernel's main paths: the bf16 prefills of llama3.2-1b
    # (one launch a layer), granite-moe-1b (one a layer), zamba2-1.2b
    # (one a shared application), musicgen-large and chameleon-34b (one a
    # layer), each at its FLASH_SHAPES row; the fp32 one's: the gemma2-2b
    # fp32 prefill, half its layers local and half global, and granite's,
    # zamba2's, musicgen's and chameleon's fp32 prefills
    flash = {(r["shape"], r["dtype"]): r for r in flash_rows}
    granite_pf = granite_row["prefill"]
    zamba_pf = zamba_row["prefill"]
    prefix_pfs = [("musicgen-large", musicgen_row["prefill"]),
                  ("chameleon-34b", chameleon_row["prefill"])]
    bf16_paths = [
        (flash[("llama3.2-1b prefill", "bfloat16")],
         prefill_row["bf16"]["flash_launches"]),
        (flash[("granite-moe-1b prefill", "bfloat16")],
         granite_pf["bf16"]["flash_launches"][fa_kernel.BF16_ROUTE]),
        (flash[("zamba2-1.2b prefill", "bfloat16")],
         zamba_pf["bf16"]["flash_launches"][fa_kernel.BF16_ROUTE])] + [
        (flash[(f"{name} prefill", "bfloat16")],
         pf["bf16"]["flash_launches"][fa_kernel.BF16_ROUTE])
        for name, pf in prefix_pfs]
    n_fa = sum(n for _, n in bf16_paths)

    def per_bf16(key):
        return sum(n * r[key] for r, n in bf16_paths)
    f32_main = [flash[(name, "float32")] for name in
                ("gemma2-2b local layer", "gemma2-2b global layer")]
    n_gemma = gemma_row["flash_launches"]
    f32_paths = [(r, n_gemma // 2) for r in f32_main] + [
        (flash[("granite-moe-1b prefill", "float32")],
         granite_pf["fp32"]["flash_launches"][fa_kernel.F32_ROUTE]),
        (flash[("zamba2-1.2b prefill", "float32")],
         zamba_pf["fp32"]["flash_launches"][fa_kernel.F32_ROUTE])] + [
        (flash[(f"{name} prefill", "float32")],
         pf["fp32"]["flash_launches"][fa_kernel.F32_ROUTE])
        for name, pf in prefix_pfs]
    n_f32 = sum(n for _, n in f32_paths)

    def per_f32(key):
        return sum(n * r[key] for r, n in f32_paths)
    # the WKV6 kernels' main path: the rwkv6-3b train run, every launch at
    # the first WKV_SHAPES row (no PyTorch call computes WKV6 or its
    # gradient: no library)
    wkv_main = wkv_rows[0]
    n_wkv = train_row["wkv6_launches"]
    n_bwd = train_row["wkv6_bwd_launches"]
    emit({"kernels": [{
        "name": "gram_batched_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/gram/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:47",
        "launches": fit_row["gram_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": per_fit("ms"), "plain_ms": per_fit("plain_ms"),
        "bound_ms": per_fit("bound_ms"),
        # the side that bounds most of the fit's bound time
        "bound_by": "bytes" if 2 * sum(
            n * r["bound_ms"] for n, r in zip(MAIN_COUNTS, main_rows)
            if r["bound_by"] == "bytes") >= per_fit("bound_ms")
        else "operations",
        "library_ms": per_fit("library_ms"),
        # the live serving path's launches: FedDCL.serve()'s onboarding
        "onboard_launches": {
            "onboard_silo": serve_row["onboard_silo"]["gram_launches"],
            "onboard_user": serve_row["onboard_user"]["gram_launches"]},
        # the paper's experiments (phase paper_experiments): FedDCL's step 3
        # on the device backend, and the scenario matrix's device column
        "paper_launches": {
            "exp1_feddcl": paper_row["exp1"]["gram_launches"],
            "exp2_mnist_feddcl": paper_row["exp2_mnist"]["gram_launches"],
            "scenarios": paper_row["scenarios"]["gram_launches"]},
        "device_ms": per_fit("device_ms"),
        "library_device_ms": per_fit("library_device_ms")}, {
        "name": "flash_attention_fwd_bf16_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:97",
        "launches": n_fa,
        "max_abs_err": max(r["max_abs_err"] for r, _ in bf16_paths),
        "ms": per_bf16("ms"), "device_ms": per_bf16("device_ms"),
        "plain_ms": per_bf16("plain_ms"), "bound_ms": per_bf16("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r, _ in bf16_paths) else "bytes",
        "library_ms": per_bf16("library_ms"),
        "launches_by_path": {"llama3.2-1b bf16 prefill": bf16_paths[0][1],
                             "granite-moe-1b bf16 prefill":
                                 bf16_paths[1][1],
                             "zamba2-1.2b bf16 prefill":
                                 bf16_paths[2][1],
                             "musicgen-large bf16 prefill":
                                 bf16_paths[3][1],
                             "chameleon-34b bf16 prefill":
                                 bf16_paths[4][1]}}, {
        "name": "flash_attention_fwd_f32_3xtf32", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:97",
        "launches": n_f32,
        "max_abs_err": max(r["max_abs_err"] for r, _ in f32_paths),
        "ms": per_f32("ms"), "device_ms": per_f32("device_ms"),
        "plain_ms": per_f32("plain_ms"), "bound_ms": per_f32("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r, _ in f32_paths) else "bytes",
        "bound_kind": f32_main[0]["bound_kind"],
        "ffma_bound_ms": per_f32("ffma_bound_ms"),
        # gemma2's: flex_attention (SDPA has no softcap); the others': SDPA
        "library_ms": per_f32("library_ms"),
        "launches_by_path": {"gemma2-2b fp32 prefill": n_gemma,
                             "granite-moe-1b fp32 prefill":
                                 f32_paths[2][1],
                             "zamba2-1.2b fp32 prefill":
                                 f32_paths[3][1],
                             "musicgen-large fp32 prefill":
                                 f32_paths[4][1],
                             "chameleon-34b fp32 prefill":
                                 f32_paths[5][1]}}, {
        "name": "wkv6_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:70",
        "launches": n_wkv, "max_abs_err": max(
            wkv_main["max_abs_err_vs_scan"],
            wkv_main["max_abs_err_vs_chunked"]),
        "ms": n_wkv * wkv_main["ms"],
        "device_ms": n_wkv * wkv_main["device_ms"],
        "plain_ms": n_wkv * wkv_main["plain_ms"],
        "bound_ms": n_wkv * wkv_main["bound_ms"],
        "bound_by": wkv_main["bound_by"], "library_ms": None,
        # serving: prefill needs the final state and takes the chunked
        # plain form, as the reference's prefill does
        "serving_launches": rwkv_serve_row["bf16"]["prefill_wkv6_launches"],
        # FedDCL's federated rounds (phase rwkv6_federated), counted from 0
        "federated_launches": fed_row["wkv6_launches"]}, {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
        "replaces": "none: the reference has no backward kernel; it takes "
                    "jax.grad of src/repro/kernels/rwkv6/ref.py::"
                    "wkv6_chunked",
        "launches": n_bwd, "max_abs_err": wkv_main["backward_max_abs_err"],
        "ms": n_bwd * wkv_main["backward_ms"],
        "device_ms": n_bwd * wkv_main["backward_device_ms"],
        # the plain version: autograd of the chunked form, recomputed
        "plain_ms": n_bwd * wkv_main["backward_recompute_ms"],
        "bound_ms": n_bwd * wkv_main["backward_bound_ms"],
        "bound_by": wkv_main["backward_bound_by"], "library_ms": None,
        "federated_bwd_launches": fed_row["wkv6_bwd_launches"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
