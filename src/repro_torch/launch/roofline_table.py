"""The dry-run's records as roofline tables (counterpart of the table code
of the reference's ``scripts/roofline_table.py`` and the ``fed_table`` of
``scripts/make_experiments_md.py``).

The reference's ``make_experiments_md.main`` concatenates a hand-kept
``EXPERIMENTS.header.md`` and hillclimb records into ``EXPERIMENTS.md``;
neither is in this repo, so that part has no counterpart here.

Traced records (the one-card mesh, or a production mesh per rank) carry
the trace's ``peak_bytes`` and ``fits_one_card``; `table` adds a "peak
GiB | fits" pair of columns when the records it shows have them. A
spec-level record (a production-mesh pair whose per-rank trace failed,
``cost_source: "specs only"``) shows its cost columns as "—".

  python -m repro_torch.launch.roofline_table [dir] [--md OUT]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = ["llama3.2-1b", "gemma2-2b", "starcoder2-15b", "rwkv6-3b",
              "granite-moe-1b-a400m", "musicgen-large", "deepseek-v3-671b",
              "glm4-9b", "zamba2-1.2b", "chameleon-34b"]
RESULT_DIR = "results_torch/dryrun"

Key = Tuple[str, str, str, str]


def load(result_dir: str = RESULT_DIR,
         include_tagged: bool = False) -> Dict[Key, Dict[str, Any]]:
    recs = {}
    for f in glob.glob(os.path.join(result_dir, "*.json")):
        name = os.path.basename(f)[:-5]
        if not include_tagged and name.count("__") > 3:
            continue                      # tagged variant record
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"], r["mode"])] = r
    return recs


def _ms(v: Optional[float]) -> str:
    return "—" if v is None else f"{v * 1e3:.1f}ms"


def table(recs, mesh: str = "16x16", mode: str = "baseline",
          fmt: str = "md") -> str:
    shown = [recs.get((a, s, mesh, mode)) for a in ARCH_ORDER
             for s in SHAPE_ORDER]
    peaks = any(r is not None and r.get("peak_bytes") is not None
                for r in shown)
    cols = 10 + (2 if peaks else 0)
    rows = ["| arch | shape | kind | compute | memory | collective | "
            "dominant | useful% | mem/dev GiB | coll GB/dev |"
            + (" peak GiB | fits |" if peaks else ""),
            "|" + "---|" * cols]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, mode))
            if r is None:
                rows.append(f"| {arch} | {shape} | — | MISSING |"
                            + " |" * (cols - 4))
                continue
            m = r["memory"]
            mem = (m["argument_bytes"] + (m["temp_bytes"] or 0)) / 2**30
            costed = r["compute_s"] is not None
            row = (f"| {arch} | {shape} | {r['kind']} | "
                   f"{_ms(r['compute_s'])} | {_ms(r['memory_s'])} | "
                   f"{_ms(r['collective_s'])} | "
                   f"{r['dominant'][:-2] if costed else '—'} | "
                   + (f"{r['useful_flops_ratio'] * 100:.1f}" if costed
                      else "—")
                   + f" | {mem:.1f} | "
                   + (f"{r['collective_bytes_per_device'] / 1e9:.1f}"
                      if costed else "—") + " |")
            if peaks:
                pk = r.get("peak_bytes")
                row += (" — | — |" if pk is None else
                        f" {pk / 2**30:.1f} | "
                        f"{'yes' if r['fits_one_card'] else 'no'} |")
            rows.append(row)
    return "\n".join(rows)


def missing(recs, mesh: str, mode: str = "baseline") -> List[Tuple[str, str]]:
    out = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            if (arch, shape, mesh, mode) not in recs:
                out.append((arch, shape))
    return out


def fed_table(result_dir: str = RESULT_DIR) -> str:
    """Cross-pod bytes from the boundary-classified ``__xs`` records (the
    dry-run's ``--multi-pod --tag xs`` in the three modes): the paper's
    communication claim on the scarce link. A record counts only with a
    measured ``cross_silo_bytes_per_device``, which the per-rank trace
    gives; a specs-only record (a failed trace) has none."""
    recs = {}
    for f in glob.glob(os.path.join(result_dir, "*__xs.json")):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("cross_silo_bytes_per_device") is not None:
            recs[(r["arch"], r["mode"])] = r
    rows = ["| arch (train_4k, 2×16×16) | baseline cross-pod GB/dev/step | "
            "feddcl local | feddcl sync | amortized (H=4) | DCI reduction | "
            "total coll (baseline→fed) |", "|" + "---|" * 7]
    for arch in ARCH_ORDER:
        b = recs.get((arch, "baseline"))
        l = recs.get((arch, "feddcl"))
        s = recs.get((arch, "feddcl_sync"))
        if not (b and l and s):
            continue
        bb = b["cross_silo_bytes_per_device"] / 1e9
        ll = l["cross_silo_bytes_per_device"] / 1e9
        ss = s["cross_silo_bytes_per_device"] / 1e9
        am = ll + ss / 4
        tot_b = b["collective_bytes_per_device"] / 1e9
        tot_l = l["collective_bytes_per_device"] / 1e9
        rows.append(f"| {arch} | {bb:.3f} | {ll:.3f} | {ss:.3f} | {am:.3f} "
                    f"| **{bb/max(am,1e-9):.0f}×** | {tot_b:.1f}→{tot_l:.1f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default=RESULT_DIR)
    ap.add_argument("--md", default=None,
                    help="also write the tables to this markdown file")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(f"records: {len(recs)}")
    meshes = sorted({k[2] for k in recs}) or ["1x1"]
    parts = []
    for mesh in meshes:
        m = missing(recs, mesh)
        print(f"mesh {mesh}: {40 - len(m)}/40 baseline pairs done; "
              f"missing: {m[:6]}")
        parts.append(f"### {mesh} baseline\n\n" + table(recs, mesh=mesh))
        for mode in ("feddcl", "feddcl_sync"):
            if any(k[2] == mesh and k[3] == mode for k in recs):
                parts.append(f"### {mesh} {mode}\n\n"
                             + table(recs, mesh=mesh, mode=mode))
    parts.append("### cross-pod bytes\n\n" + fed_table(args.dir))
    text = "\n\n".join(parts)
    print()
    print(text)
    if args.md:
        with open(args.md, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
