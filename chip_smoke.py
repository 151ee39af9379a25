"""Drive the PyTorch/CUDA port of FedDCL on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout (nvcc, at
first use), holds it against its plain PyTorch version at the protocol's
shapes, runs Algorithm 1 end to end through the port's public API at the
width of the paper's mnist model (784 -> m̃ = m̂ = 50, MLP 50-500-100-10;
Experiment II layout d = 5 groups x c = 4 users x 100 samples, 2000 anchor
rows, 20 rounds x 4 local epochs, batch 32), and checks what comes out.

Each phase prints one JSON line. The line before the last lists every
kernel with its launches on the main path, error and times; the last line
is {"ok": true, "device": {...}}. Any failure exits non-zero before it.
Without CUDA, or without the rest of the repository beside it, the script
fails and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import FedDCL  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.federated import run_federated  # noqa: E402
from repro_torch.data.partition import split_iid  # noqa: E402
from repro_torch.data.tabular import make_dataset, train_test_split  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gram import kernel as gram_kernel  # noqa: E402
from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# Published dense peaks of the H100 SXM (NVIDIA data sheet): fp32 FFMA
# outside the tensor cores, and device-memory bandwidth, in units per second.
H100_SXM = {"fp32_flops": 67e12, "bytes": 3.35e12}

# the Experiment II layout at the width of the paper's mnist model
D, C, N_IJ, M_TILDE, ANCHOR_R = 5, 4, 100, 50, 2000
FIT_LAUNCHES = 2 + D     # groups' batched Gram, central Gram, D onboarding Grams
MAIN_SHAPES = [(D, ANCHOR_R, C * M_TILDE), (1, ANCHOR_R, D * M_TILDE),
               (1, ANCHOR_R, C * M_TILDE)]
MAIN_COUNTS = [1, 1, D]  # launches of each shape in one fit
EXTRA_SHAPES = [(3, 1037, 77),            # ragged edges in r and m
                (16, 8192, 1024)]         # a large deployment: 512 MiB in
GRAM_TOL = 1e-5          # kernel vs plain, relative Frobenius (fp32 FFMA)
DEVICE_HOST_TOL = 1e-3   # the reference's device-vs-host bar
ONBOARD_TOL = 1e-5       # incremental == recompute on device


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


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


# -- phase 1 ---------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_library(gram_kernel.SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in build.build_log.get("gram.cu", "").splitlines()
             if "registers" in l or "spill" in l]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "nvcc_s": build.build_seconds.get("gram.cu"), "ptxas": ptxas})
    return smi


# -- phase 2 ---------------------------------------------------------------

def phase_kernel_check(peak):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in MAIN_SHAPES + EXTRA_SHAPES:
        b, r, m = shape
        a = torch.randn(shape, generator=gen, device=dev)
        g = gram_ops.gram_batched(a)
        g_ref = gram_ops.gram_batched(a, backend="ref")
        torch.cuda.synchronize()
        err = float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref))
        max_abs = float((g - g_ref).abs().max())
        reps = 5 if r * m * b > 1e8 else 50
        ms = time_ms(lambda: gram_ops.gram_batched(a), reps)
        plain_ms = time_ms(lambda: gram_ops.gram_batched(a, backend="ref"), reps)
        library_ms = time_ms(lambda: torch.bmm(a.mT, a), reps)
        # the output is symmetric: one triangle and the diagonal is all the
        # function needs, though the kernel computes every tile
        flops = 1.0 * b * r * m * (m + 1)
        nbytes = 4.0 * (b * r * m + b * m * m)
        t_ops = flops / peak["fp32_flops"] * 1e3
        t_bytes = nbytes / peak["bytes"] * 1e3
        row = {"phase": "kernel_check", "shape": list(shape),
               "rel_frobenius": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflops_per_s": flops / ms / 1e6}
        emit(row)
        rows.append(row)
        check(err <= GRAM_TOL, f"gram kernel vs plain at {shape}: {err}")
        del a, g, g_ref
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


def phase_fit(dev, rounds: int = 20):
    t0 = time.perf_counter()
    Xs, Ys, Xte, Yte = mnist_exp2_layout()
    data_s = time.perf_counter() - t0
    model = FedDCL(m_tilde=M_TILDE, hidden=(500, 100), task="classification",
                   rounds=rounds, local_epochs=4, batch_size=32,
                   anchor_r=ANCHOR_R, svd_backend="device", engine="host",
                   device=dev)
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
    row = {"phase": "fit", "layout": {"d": D, "c": C, "n_ij": N_IJ,
                                      "m": 784, "m_tilde": M_TILDE,
                                      "anchor_r": ANCHOR_R,
                                      "mlp": [M_TILDE, 500, 100, 10],
                                      "rounds": rounds, "local_epochs": 4,
                                      "batch_size": 32},
           "data_s": data_s, "steps_1_3_s": model.fit_seconds_["protocol"],
           "step_4_s": model.fit_seconds_["federated"],
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
    return model, (Xs, Ys, Xte, Yte), row


def phase_step4_profile(model):
    """One more federated round of the fitted model under torch.profiler:
    the device's busy share of step 4 (kernel time over wall time; the
    profiler's own overhead inflates the wall, so the share is a floor)."""
    from torch.profiler import ProfilerActivity, profile
    loss = lambda p, x, y: mlp.mlp_per_example_loss(p, x, y, model.task)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_federated(loss, model.params_, model.setup_.fed_silos(),
                      opt=adamw(model.lr), rounds=1,
                      local_epochs=model.local_epochs,
                      batch_size=model.batch_size, seed=model.seed + 2,
                      device=model.device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in events)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    steps = D * model.local_epochs * -(-C * N_IJ // model.batch_size)
    row = {"phase": "step4_profile", "rounds": 1, "optimizer_steps": steps,
           "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall_s,
           "kernel_launches": launches,
           "launches_per_step": launches / steps}
    emit(row)
    check(busy_us > 0, "the profiler saw no device time in step 4")
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
    phase_step4_profile(model)
    phase_device_vs_host(model, data)
    main_rows = rows[:len(MAIN_SHAPES)]

    def per_fit(key):
        return sum(n * r[key] for n, r in zip(MAIN_COUNTS, main_rows))

    emit({"kernels": [{
        "name": "gram_batched_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/gram/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:47",
        "launches": fit_row["gram_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": per_fit("ms"), "plain_ms": per_fit("plain_ms"),
        "bound_ms": per_fit("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in main_rows) else "bytes",
        "library_ms": per_fit("library_ms")}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
