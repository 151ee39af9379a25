"""Roofline terms of a dry-run (counterpart of ``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power
limit — the peaks of NVIDIA's data sheet, dense, which PERF.md's kernel
bounds use too:
    peak   989 TFLOP/s bf16 per card
    HBM    3.35 TB/s per card
    NVLink 450 GB/s per direction per card

Terms (seconds, per step, per card):
    compute    = flops_per_device / peak
    memory     = bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / link_bw

The reference reads its costs from a compiled XLA artifact and parses the
collectives out of its post-SPMD HLO text. The port compiles nothing: the
dry-run (``launch.dryrun``) counts flops, bytes accessed and live bytes
while it traces a step on fake tensors, and a collective is a record
{"kind", "bytes", "groups"} as ``core.federated.SiloComm`` keeps them
(this rank's result bytes; every rank group of the collective's axis, as
lists of ranks). So ``parse_replica_groups`` and the HLO regexes have no
counterpart: the port emits no HLO, and its groups are rank lists
already. Collective bytes are raw result-buffer bytes, with the per-kind
breakdown, as the reference reports them.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Mapping, Tuple

HW = {
    "peak_flops": 989e12,       # bf16 FLOP/s per card (H100 SXM, 700 W)
    "hbm_bw": 3.35e12,          # B/s per card
    "link_bw": 450e9,           # B/s NVLink per direction
    # torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100
    # 80GB HBM3 (700 W), read by chip_smoke.py's dryrun phase
    "hbm_bytes": 85_017_493_504,
}

Record = Mapping[str, Any]


def iter_collectives(records: Iterable[Record]
                     ) -> Iterator[Tuple[str, int, List[List[int]]]]:
    """(kind, result bytes, rank groups) of every collective record."""
    for r in records:
        yield r["kind"], int(r["bytes"]), [list(g) for g in r["groups"]]


def collective_bytes(records: Iterable[Record]) -> Dict[str, int]:
    """Per-device bytes by collective kind, and their ``total``."""
    out: Dict[str, int] = {}
    for kind, nbytes, _ in iter_collectives(records):
        out[kind] = out.get(kind, 0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def model_flops(cfg, shape, kind: str, local_steps: int = 1) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active,
    non-embedding params; D = tokens processed by the program."""
    from repro_torch.models.backbone import count_params_analytic

    n = count_params_analytic(cfg, active_only=True, include_embed=False)
    if kind in ("train", "fed_local"):
        # fed_local processes the full global batch (d silos × local batch)
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if kind == "fed_sync":
        return 0.0
    if kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def cross_block_bytes(records: Iterable[Record], block: int) -> int:
    """Per-device bytes of collectives whose rank groups span more than
    one contiguous block of `block` ranks — traffic that must cross the
    silo / pod boundary (ranks are laid out silo-major)."""
    total = 0
    for _kind, nbytes, groups in iter_collectives(records):
        for grp in groups:
            if len({r // block for r in grp}) > 1:
                total += nbytes
                break
    return total


def analyze(measured: Mapping[str, Any], cfg, shape, kind: str, *,
            chips: int, local_steps: int = 1,
            silo_block: int = 0) -> Dict[str, Any]:
    """The reference's record from the dry-run's counters: `measured`
    holds ``flops``, ``bytes_accessed`` (per device), ``collectives``
    (records) and ``memory`` (argument / output / temp / alias bytes)."""
    records = list(measured.get("collectives") or [])
    coll = collective_bytes(records)

    flops_dev = float(measured["flops"])
    bytes_dev = float(measured["bytes_accessed"])
    coll_dev = float(coll.get("total", 0))

    compute_s = flops_dev / HW["peak_flops"]
    memory_s = bytes_dev / HW["hbm_bw"]
    collective_s = coll_dev / HW["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, shape, kind, local_steps)
    hlo_global = flops_dev * chips
    xs_bytes = cross_block_bytes(records, silo_block) if silo_block else None
    return {
        **({"cross_silo_bytes_per_device": xs_bytes,
            "silo_block": silo_block} if xs_bytes is not None else {}),
        "arch": cfg.name,
        "shape": shape.name,
        "kind": kind,
        "chips": chips,
        "flops_per_device": flops_dev,
        # the reference's key: the flops the program computes, all devices
        "hlo_flops_global": hlo_global,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_breakdown": coll,
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "roofline_bound_s": max(terms.values()),
        "memory": dict(measured["memory"]),
    }


def fmt_row(r: Dict[str, Any]) -> str:
    return (f"{r['arch']:>22s} {r['shape']:>11s} {r['kind']:>9s} "
            f"C={r['compute_s']*1e3:9.3f}ms M={r['memory_s']*1e3:9.3f}ms "
            f"X={r['collective_s']*1e3:9.3f}ms dom={r['dominant'][:-2]:>10s} "
            f"useful={r['useful_flops_ratio']*100:5.1f}% "
            f"mem/dev={(r['memory']['argument_bytes']+r['memory']['temp_bytes'])/2**30:6.2f}GiB")
