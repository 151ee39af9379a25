"""What the kernel-variant scripts (flash_f32_variants.py, wkv6_variants.py)
share: variants of a CUDA source made by text substitution, each built in a
directory of its own under the ignored kernels/build/variants/, and timed in
turns against the committed source through the port's own wrapper.

Not run by itself; each script imports it (run them from the repo root as
`python3 scripts/<name>.py`, on a machine with a CUDA device).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def variant_sources(source: Path, variants) -> dict:
    """Each variant (name -> [(old, new), ...]) in a directory of its own:
    the source and the headers beside it, with each substitution made in
    whichever file holds its text. Returns name -> the variant's source."""
    base = {source.name: source.read_text()}
    base.update({h.name: h.read_text()
                 for h in source.parent.glob("*.cuh")})
    paths = {}
    for name, subs in variants.items():
        files = dict(base)
        for old, new in subs:
            where = [f for f, text in files.items() if old in text]
            if not where:
                raise SystemExit(f"variant {name}: {source.name} and its "
                                 f"headers no longer have "
                                 f"{old.splitlines()[0]!r}")
            files[where[0]] = files[where[0]].replace(old, new)
        out_dir = build.BUILD_DIR / "variants" / f"{source.stem}_{name}"
        out_dir.mkdir(parents=True, exist_ok=True)
        paths[name] = out_dir / f"{source.stem}_{name}.cu"
        paths[name].write_text(files.pop(source.name))
        for f, text in files.items():
            (out_dir / f).write_text(text)
    return paths


def build_all(paths: dict, tag: dict) -> dict:
    """Builds every variant (in parallel) and prints each one's ptxas
    report as a JSON line beside `tag`. Returns name -> its library."""
    libs = dict(zip(paths, build.load_libraries(list(paths.values()))))
    for name, path in paths.items():
        log = build.build_log.get(path.name, "")
        print(json.dumps({**tag, "variant": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)
    return libs


def time_ms(fn, reps: int) -> float:
    """The median time of a warm call between CUDA events, in ms."""
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


def in_turns(names, use, call, reps: int) -> dict:
    """Each variant's time, twice, in turns (a, b, ..., b, a): use(name)
    puts the variant's entry point in the wrapper, call() runs it."""
    ms = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        use(name)
        ms[name].append(time_ms(call, reps))
    return ms
