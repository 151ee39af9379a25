"""The port's lint (``repro_torch.analysis.lint``) against the reference's
(``repro.analysis.lint``): the same (rule, line, col) violations on every
fixture of ``tests/test_analysis.py`` and on every module of ``src/repro/``
with its ``feddcl-lint:`` directives stripped; one bad / good fixture pair
per torch form of a rule (bad fires exactly once, good never); the
disable directives on torch forms; the CLI's exit codes, ``--json`` and
``--rules``; and the port's default roots lint clean.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("jax")

from repro.analysis import lint as jlint  # noqa: E402
from test_analysis import FIXTURES  # noqa: E402

from repro_torch.analysis import lint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _key(violations):
    return [(v.rule, v.line, v.col) for v in violations]


def _lint(src):
    return lint.lint_source(textwrap.dedent(src))


# --------------------------------------------------------------------------
# parity with the reference's lint on the reference's code
# --------------------------------------------------------------------------

def test_same_rules_as_the_reference():
    assert set(lint.RULES) == set(jlint.RULES)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_reference_fixtures_agree(rule):
    for src in FIXTURES[rule]:
        src = textwrap.dedent(src)
        assert _key(lint.lint_source(src)) == _key(jlint.lint_source(src))
    assert [v.rule for v in _lint(FIXTURES[rule][0])] == [rule]


def test_reference_package_agrees_with_directives_stripped():
    """Every module of src/repro/, its allowlist directives stripped in
    memory so the allowlisted sites count too."""
    strip = re.compile(r"#\s*feddcl-lint:.*$", re.M)
    files = sorted((ROOT / "src" / "repro").rglob("*.py"))
    assert len(files) > 40
    total, differ = 0, []
    for f in files:
        src = strip.sub("", f.read_text())
        want = _key(jlint.lint_source(src, str(f)))
        total += len(want)
        if _key(lint.lint_source(src, str(f))) != want:
            differ.append(f.name)
    assert differ == []
    assert total > 0                    # the stripped sites are found


def test_torch_forms_need_a_torch_import():
    """The same text without `import torch` is the reference's case."""
    src = "def drive(rounds, losses):\n" \
          "    for rnd in range(rounds):\n" \
          "        print(losses[rnd].item())\n"
    assert lint.lint_source(src) == []
    assert [v.rule for v in lint.lint_source("import torch\n" + src)] == \
        ["R008"]


# --------------------------------------------------------------------------
# the torch forms: one (bad, good) pair each
# --------------------------------------------------------------------------

TORCH_FIXTURES = {
    "R003 manual_seed": ("R003", """
        import torch
        torch.manual_seed(0)
        x = torch.randn(4, generator=torch.Generator())
        """, """
        import torch
        g = torch.Generator().manual_seed(0)
        x = torch.randn(4, generator=g)
        """),
    "R003 draw without generator": ("R003", """
        import torch
        idx = torch.randperm(10)
        """, """
        import torch
        idx = torch.randperm(10, generator=torch.Generator().manual_seed(0))
        """),
    "R004 graphs.capture": ("R004", """
        import torch
        from repro_torch.graphs import capture

        def build(X, dev):
            data = torch.as_tensor(X, device=dev)

            def step():
                return data.sum()
            return capture(step, dev)
        """, """
        from types import SimpleNamespace
        import torch
        from repro_torch.graphs import capture

        def build(X, dev):
            b = SimpleNamespace(X=torch.empty(X.shape, device=dev))

            def step():
                return b.X.sum()
            graph, out = capture(step, dev)
            b.X.copy_(torch.as_tensor(X))
            graph.replay()
            return out
        """),
    "R004 torch.compile decorator": ("R004", """
        import torch
        table = torch.zeros(8, 4)

        @torch.compile
        def f(i):
            return table[i]
        """, """
        import torch
        table = torch.zeros(8, 4)

        @torch.compile
        def f(t, i):
            return t[i]

        row = f(table, 0)
        """),
    "R004 torch.compile call": ("R004", """
        import torch
        W = torch.load("w.pt")
        f = torch.compile(lambda x: x @ W)
        """, """
        import torch
        W = torch.load("w.pt")
        f = torch.compile(lambda x, w: x @ w)
        y = f(torch.ones(2, 2), W)
        """),
    "R004 make_graphed_callables": ("R004", """
        import torch

        def build(X):
            data = torch.from_numpy(X).cuda()

            def fwd(x):
                return x + data
            return torch.cuda.make_graphed_callables(fwd, (data,))
        """, """
        import torch

        def build(X):
            data = torch.from_numpy(X).cuda()

            def fwd(x, d):
                return x + d
            return torch.cuda.make_graphed_callables(fwd, (data, data))
        """),
    "R004 torch.cuda.graph": ("R004", """
        import torch

        def build(X, dev):
            data = torch.tensor(X).to(dev)
            g = torch.cuda.CUDAGraph()

            def step():
                return data * 2
            with torch.cuda.graph(g):
                out = step()
            return g, out
        """, """
        import torch

        def build(X, dev):
            buf = {"x": None}
            g = torch.cuda.CUDAGraph()

            def step():
                return buf["x"] * 2
            with torch.cuda.graph(g):
                out = step()
            return g, out
        """),
    "R004 batch_loss of a plan": ("R004", """
        import torch
        from repro_torch.core.federated import make_fl_plan

        def plan(padded, loss, opt):
            X = torch.as_tensor(padded.X)
            return make_fl_plan(
                num_silos=3, num_batches=2, batch_size=8, opt=opt,
                local_epochs=1,
                batch_loss=lambda p, x, y, w, r: loss(p, X[0], y, w, r))
        """, """
        import torch
        from repro_torch.core.federated import make_fl_plan

        def plan(padded, loss, opt):
            X = torch.as_tensor(padded.X)
            out = make_fl_plan(
                num_silos=3, num_batches=2, batch_size=8, opt=opt,
                local_epochs=1,
                batch_loss=lambda p, x, y, w, r: loss(p, x, y, w, r))
            return out, X
        """),
    "R005 .float()": ("R005", """
        import torch
        sizes = torch.tensor([10, 20])
        w = sizes.float() / 30
        """, """
        import torch
        sizes = torch.tensor([10, 20])
        w = (sizes.double() / sizes.sum()).float()
        """),
    "R005 .to(float32)": ("R005", """
        import torch

        def weights(counts):
            return counts.to(torch.float32)
        """, """
        import torch

        def weights(counts):
            return (counts / counts.sum()).to(torch.float32)
        """),
    "R005 torch.tensor dtype": ("R005", """
        import torch

        def weights(sizes):
            return torch.tensor(sizes, dtype=torch.float32)
        """, """
        import torch

        def weights(sizes):
            return torch.tensor(sizes, dtype=torch.int64)
        """),
    "R005 torch.as_tensor dtype": ("R005", """
        import torch

        def weights(sizes):
            return torch.as_tensor(sizes, torch.float32)
        """, """
        import numpy as np
        import torch

        def weights(sizes):
            return torch.as_tensor(sizes / np.sum(sizes), torch.float32)
        """),
    "R006 torch.clamp": ("R006", """
        import torch

        def norm(l, w):
            return torch.sum(w * l) / torch.clamp(torch.sum(w), min=1.0)
        """, """
        import torch

        def norm(l, w):
            return torch.sum(w * l) / torch.clamp(torch.sum(w), min=1e-12)
        """),
    "R006 clamp_min": ("R006", """
        import torch

        def norm(l, mask):
            return (mask * l).sum() / mask.sum().clamp_min(1)
        """, """
        import torch

        def norm(l, mask):
            return (mask * l).sum() / mask.sum().clamp_min(1e-12)
        """),
    "R007 torch.save": ("R007", """
        import torch

        def save(path, state):
            torch.save(state, path)
        """, """
        import os
        import tempfile
        import torch

        def save(path, state):
            fd, tmp = tempfile.mkstemp(suffix=".pt")
            with os.fdopen(fd, "wb") as f:
                torch.save(state, f)
            os.replace(tmp, path)
        """),
    "R008 .item()": ("R008", """
        import torch

        def drive(step, rounds):
            for rnd in range(rounds):
                print(step(rnd).item())
        """, """
        import torch

        def drive(step, rounds):
            losses = torch.stack([step(rnd) for rnd in range(rounds)])
            print(losses.tolist())
        """),
    "R008 .cpu().numpy()": ("R008", """
        import torch

        def drive(step, rounds):
            out = []
            for rnd in range(rounds):
                out.append(step(rnd).cpu().numpy())
            return out
        """, """
        import torch

        def drive(step, rounds):
            out = [step(rnd) for rnd in range(rounds)]
            return torch.stack(out).cpu().numpy()
        """),
    "R008 synchronize": ("R008", """
        import torch

        def drive(step, n_rounds):
            while n_rounds:
                step()
                torch.cuda.synchronize()
                n_rounds -= 1
        """, """
        import torch

        def drive(step, n_rounds):
            while n_rounds:
                step()
                n_rounds -= 1
            torch.cuda.synchronize()
        """),
}


@pytest.mark.parametrize("form", sorted(TORCH_FIXTURES))
def test_torch_form_fires_exactly_once(form):
    rule, bad, good = TORCH_FIXTURES[form]
    vs = _lint(bad)
    assert [v.rule for v in vs] == [rule], (form, [v.format() for v in vs])
    assert vs[0].line > 0 and vs[0].snippet
    assert _lint(good) == [], (form, [v.format() for v in _lint(good)])
    # the reference's lint knows none of these forms
    assert jlint.lint_source(textwrap.dedent(bad)) == []


def test_each_torch_form_has_its_own_message():
    msgs = {}
    for form, (rule, bad, _) in TORCH_FIXTURES.items():
        # the message without the name and the constant it quotes
        stem = re.sub(r"'[^']*'|\b\d+(\.\d+)?\b", "_",
                      _lint(bad)[0].message)
        msgs.setdefault(rule, set()).add(stem)
    # graphs.capture, torch.compile (call and decorator alike),
    # make_graphed_callables, torch.cuda.graph, a plan's batch_loss
    assert len(msgs["R004"]) == 5
    assert len(msgs["R003"]) == 2
    assert all(m.startswith("clamp(sum(") for m in msgs["R006"])


def test_torch_disable_directives():
    _, bad, _ = TORCH_FIXTURES["R008 .item()"]
    lines = textwrap.dedent(bad).strip().splitlines()
    trailing = "\n".join(
        ln + "  # feddcl-lint: disable=R008  fixture" if ".item()" in ln
        else ln for ln in lines)
    assert lint.lint_source(trailing) == []
    preceding = "\n".join(
        f"    # feddcl-lint: disable=R008  fixture\n{ln}" if ".item()" in ln
        else ln for ln in lines)
    assert lint.lint_source(preceding) == []
    assert lint.lint_source("# feddcl-lint: disable-file=R008  fixture\n"
                            + "\n".join(lines)) == []
    survived = lint.lint_source("# feddcl-lint: disable-file=R003  fixture\n"
                                + "\n".join(lines))
    assert [v.rule for v in survived] == ["R008"]


def test_syntax_error_reported_not_raised():
    vs = lint.lint_source("import torch\ndef broken(:\n")
    assert len(vs) == 1 and vs[0].rule == "E000"


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *argv],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "")})


def test_cli_json_and_exit_codes(tmp_path):
    f = tmp_path / "mixed.py"
    f.write_text(textwrap.dedent(TORCH_FIXTURES["R008 .item()"][1]) +
                 textwrap.dedent(FIXTURES["R001"][0]))
    r = _cli(str(f), "--json")
    assert r.returncode == 1, r.stderr
    doc = json.loads(r.stdout)
    assert doc["files_checked"] == 1
    assert sorted(v["rule"] for v in doc["violations"]) == ["R001", "R008"]
    r = _cli(str(f), "--rules", "R001", "--json")
    assert r.returncode == 1
    assert [v["rule"] for v in json.loads(r.stdout)["violations"]] == ["R001"]
    assert _cli(str(f), "--rules", "R999").returncode == 2
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent(TORCH_FIXTURES["R008 .item()"][2]))
    r = _cli(str(good))
    assert r.returncode == 0 and "0 violation(s) in 1 file(s)" in r.stdout


def test_cli_clean_on_the_port_without_torch():
    """The default roots (the package, chip_smoke.py and the scripts that
    import repro_torch) lint clean, and the lint imports no torch."""
    roots = lint.default_roots()
    assert str(ROOT / "chip_smoke.py") in roots
    assert str(ROOT / "src" / "repro_torch") in roots
    scripts = {Path(p).name for p in roots if "scripts" in p}
    assert "fed_warmup_profile.py" in scripts
    assert "feddcl_lint.py" not in scripts and "feddcl_audit.py" not in scripts
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout
    code = ("import sys, runpy\nsys.argv = ['lint']\n"
            "try:\n    runpy.run_module('repro_torch.analysis.lint', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\nprint('no torch')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={"PYTHONPATH": "src",
                            "PATH": os.environ.get("PATH", "")})
    assert r.returncode == 0 and "no torch" in r.stdout, r.stdout + r.stderr
