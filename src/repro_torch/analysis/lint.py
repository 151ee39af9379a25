"""AST lint of the port (counterpart of ``repro.analysis.lint``): each rule
encodes one regression the reference actually shipped, with the forms it
takes in torch code beside the reference's JAX forms.

  R001  `time.time()` in a perf path — wall clock jumps under NTP slew;
        timing must use `time.perf_counter()`.
  R002  builtin `hash()` for seeds/keys — str hashing is salted per
        process, so "deterministic" seeds differ between runs.
  R003  global-state RNG: `np.random.*` (seed/rand/randn/…);
        torch: `torch.manual_seed` and `torch.rand` / `randn` / `randint` /
        `randperm` / `normal` / `bernoulli` / `multinomial` without
        `generator=` — draws coupled through one hidden generator. Use
        `np.random.default_rng(seed)` or an explicit `torch.Generator`.
  R004  a compiled or captured function closing over an array — the data
        is baked into what is built: a jitted function; torch: a function
        handed to `graphs.capture`, `torch.cuda.make_graphed_callables` or
        `torch.compile` (call or decorator), a function called inside
        `with torch.cuda.graph(...)`, or a `batch_loss=` of
        `make_fl_plan` / `FLPlan` (a cached plan serves every tenant).
        Data must enter as arguments (or be copied into static buffers).
  R005  float32 casts on sample counts/sizes — float32 collapses integers
        above 2^24, silently corrupting FedAvg weights; torch: `.float()`,
        `.to(torch.float32)`, `torch.tensor` / `torch.as_tensor(…,
        dtype=torch.float32)`.
  R006  dividing by a weight-mass sum without a tiny-eps guard — a bare
        `/ w.sum()` NaNs at zero mass; a clamp constant > 1e-6
        (`maximum(Σw, 1)`; torch: `torch.clamp(Σw, min=c)`,
        `.clamp_min(c)`) deflates losses at fractional weight mass.
  R007  `np.save*` / `torch.save` writes not going through `mkstemp` —
        guess-renamed sibling names race concurrent savers.
  R008  a host sync inside a lax.scan body or a per-round loop
        (`device_get` / `block_until_ready`; torch: `.item()`,
        `.tolist()`, `.cpu()`, `.numpy()`, `torch.cuda.synchronize()`) —
        one sync per round re-serializes the engine that runs rounds back
        to back (stream ONE transfer per eval chunk instead).

The torch forms apply to modules that import `torch` or `repro_torch`, so
on the reference's JAX code this lint reports exactly what
``repro.analysis.lint`` reports.

Allowlisting: a deliberate exception carries a trailing (or
immediately-preceding-line) comment

    # feddcl-lint: disable=R008  <why this site is allowed>

and a whole file can opt out of a rule with

    # feddcl-lint: disable-file=R003  <why>

The disable comment is the audit trail: the justification text rides in
the source next to the exception.

Pure stdlib (ast + re): importable without torch. The CLI:

    PYTHONPATH=src python -m repro_torch.analysis.lint [roots] [--json] [--rules R001,R008]

lints the port (`src/repro_torch`, `chip_smoke.py` and the scripts under
`scripts/` that import `repro_torch`) unless given roots. Exit status: 0
clean, 1 violations found, 2 bad invocation.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "R001": "time.time() used where perf_counter is required "
            "(wall clock is not monotonic)",
    "R002": "builtin hash() used for seeding/keys "
            "(str hashing is salted per process)",
    "R003": "global-state np.random.* / torch RNG call "
            "(use np.random.default_rng / an explicit torch.Generator)",
    "R004": "jitted, compiled or captured function closes over an array "
            "(data baked into what is built — pass it as an argument)",
    "R005": "float32 cast on a sample count/size "
            "(float32 collapses integers above 2^24)",
    "R006": "division by a weight-mass sum without a tiny-eps guard "
            "(use maximum / clamp(sum, eps<=1e-6), cf. _DEN_EPS)",
    "R007": "np.save*/torch.save checkpoint write not going through "
            "tempfile.mkstemp (non-atomic writes race concurrent savers)",
    "R008": "host sync inside a scan body or per-round loop "
            "(a host sync per round re-serializes the compiled phase)",
}

_DISABLE_RE = re.compile(
    r"#\s*feddcl-lint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s{2,}|#|$)")
_DISABLE_FILE_RE = re.compile(
    r"#\s*feddcl-lint:\s*disable-file=([A-Za-z0-9_,\s]+?)(?:\s{2,}|#|$)")

# R003: the np.random module-level functions that mutate the hidden global
# RandomState. Constructors of explicit generators are fine.
_NP_GLOBAL_RANDOM = {
    "seed", "random", "rand", "randn", "randint", "random_sample", "ranf",
    "sample", "normal", "standard_normal", "uniform", "choice",
    "permutation", "shuffle", "binomial", "poisson", "beta", "gamma",
    "exponential", "lognormal", "laplace", "multivariate_normal",
    "get_state", "set_state", "random_integers", "bytes", "dirichlet",
}
# ... torch: seeding the process-global generator, and draws from it
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.random.manual_seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}

# R004: calls whose result is (almost certainly) a host or device array.
_ARRAY_CONSTRUCTORS = {
    "numpy.array", "numpy.asarray", "numpy.zeros", "numpy.ones",
    "numpy.full", "numpy.arange", "numpy.linspace", "numpy.empty",
    "numpy.eye", "numpy.stack", "numpy.concatenate", "numpy.load",
    "jax.numpy.array", "jax.numpy.asarray", "jax.numpy.zeros",
    "jax.numpy.ones", "jax.numpy.full", "jax.numpy.arange",
    "jax.numpy.linspace", "jax.numpy.eye", "jax.numpy.stack",
    "jax.numpy.concatenate", "jax.device_put",
}
_TORCH_ARRAY_CONSTRUCTORS = {
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.zeros",
    "torch.ones", "torch.full", "torch.empty", "torch.arange",
    "torch.stack", "torch.cat", "torch.load",
}
# ... and generator draw methods (rng.standard_normal(...) etc.)
_ARRAY_METHODS = {
    "standard_normal", "normal", "random", "uniform", "integers",
    "choice", "permutation",
}
# ... torch: a device move of an array (`x.to(dev)`, `x.cuda()`)
_TORCH_MOVES = {"to", "cuda"}

# R004, torch: what builds from a function (the call's first argument) and
# the plan constructors that take the per-batch loss as `batch_loss=`
_TORCH_COMPILERS = {"torch.compile": "torch.compile",
                    "torch.cuda.make_graphed_callables":
                        "torch.cuda.make_graphed_callables",
                    "repro_torch.graphs.capture": "graphs.capture"}
_PLAN_BUILDERS = ("make_fl_plan", "FLPlan")
_CUDA_GRAPH_CTX = "torch.cuda.graph"

# R005: identifiers that name sample counts/sizes.
_COUNTY_RE = re.compile(r"(size|sizes|count|counts|n_samples|num_samples)",
                        re.IGNORECASE)

# R006: identifiers that name sample-weight / mask vectors.
_WEIGHTY = {"w", "ws", "wb", "wn", "wr", "mask", "masks", "weights"}
_WEIGHTY_RE = re.compile(r"(weight|mass)", re.IGNORECASE)

# R008: loop headers that advance federated rounds.
_ROUNDY_RE = re.compile(r"(round|rnd)", re.IGNORECASE)
_TORCH_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

_F32_NAMES = {"numpy.float32", "jax.numpy.float32"}
_TORCH_F32_NAMES = {"torch.float32", "torch.float"}


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}" + (f"  [{self.snippet}]" if self.snippet
                                     else ""))


def _parse_disables(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Per-line and file-level `# feddcl-lint: disable=` directives."""
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_FILE_RE.search(text)
        if m:
            whole_file |= {r.strip().upper()
                           for r in m.group(1).split(",") if r.strip()}
            continue
        m = _DISABLE_RE.search(text)
        if m:
            per_line[i] = {r.strip().upper()
                           for r in m.group(1).split(",") if r.strip()}
    return per_line, whole_file


def _const_number(node: Optional[ast.AST]) -> Optional[float]:
    if isinstance(node, ast.Constant) and \
            isinstance(node.value, (int, float)) and \
            not isinstance(node.value, bool):
        return float(node.value)
    return None


class _Scope:
    """One lexical function/module scope: names bound here, array-valued
    names bound here, and functions defined here (for jit(f) resolution)."""

    def __init__(self, node: Optional[ast.AST]) -> None:
        self.node = node
        self.bound: Set[str] = set()
        self.arrays: Set[str] = set()
        self.functions: Dict[str, ast.AST] = {}


class _Linter(ast.NodeVisitor):
    def __init__(self, source: str, path: str) -> None:
        self.path = path
        self.lines = source.splitlines()
        self.aliases: Dict[str, str] = {}     # local name -> dotted module path
        self.scopes: List[_Scope] = []
        self.violations: List[Violation] = []
        # the torch forms apply to modules that import torch / repro_torch
        self.torch = False
        # R008 context flags
        self._round_loop_depth = 0
        self._scan_bodies: Set[ast.AST] = set()
        self._in_scan_body = 0
        self._reported_syncs: Set[int] = set()
        # R007: function nodes that call mkstemp somewhere inside
        self._mkstemp_funcs: Set[ast.AST] = set()

    # ---------------------------------------------------------------- utils

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        snippet = self.lines[line - 1].strip() if 0 < line <= len(self.lines) \
            else ""
        self.violations.append(Violation(
            rule=rule, path=self.path, line=line,
            col=getattr(node, "col_offset", 0) + 1, message=message,
            snippet=snippet[:120]))

    def _dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve an attribute chain through the import aliases:
        `np.random.seed` -> "numpy.random.seed"."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))

    def _idents(self, node: ast.AST) -> List[str]:
        out = []
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                out.append(n.id)
            elif isinstance(n, ast.Attribute):
                out.append(n.attr)
        return out

    @staticmethod
    def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
        return next((k.value for k in node.keywords if k.arg == name), None)

    # ------------------------------------------------------------- imports

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for a in node.names:
                self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        self.generic_visit(node)

    # ------------------------------------------------------------ scoping

    def visit_Module(self, node: ast.Module) -> None:
        # aliases first: the prescan below resolves jnp.asarray & co., so
        # module-level `data = jnp.asarray(...)` must already see the
        # import table (imports textually follow nothing at module level,
        # but the prescan walks assignments before generic_visit reaches
        # the Import nodes)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                self.visit_Import(sub)
            elif isinstance(sub, ast.ImportFrom):
                self.visit_ImportFrom(sub)
        self.torch = any(v.split(".")[0] in ("torch", "repro_torch")
                         for v in self.aliases.values())
        self.scopes.append(_Scope(node))
        self._prescan(node)
        self.generic_visit(node)
        self.scopes.pop()

    def _prescan(self, node: ast.AST) -> None:
        """Record this scope's array-valued assignments and local function
        defs (one pass ahead of the main walk, so forward references and
        `jit(f)`-after-def both resolve). Walks THIS scope only: nested
        function/lambda bodies are their own scopes, prescanned on entry.
        An assignment from a device move of an array name (torch: `y =
        x.to(dev)`) counts once `x` is known, so the assignments are
        swept until no new array name appears."""
        scope = self.scopes[-1]
        body = getattr(node, "body", None)
        if not isinstance(body, list):       # Lambda: single expression
            return
        assigns: List[Tuple[List[ast.AST], ast.AST]] = []
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.functions.setdefault(n.name, n)
                continue                     # nested scope: don't descend
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Assign):
                assigns.append((n.targets, n.value))
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                assigns.append(([n.target], n.value))
            stack.extend(ast.iter_child_nodes(n))
        grew = True
        while grew:
            grew = False
            for targets, value in assigns:
                names = [t.id for t in targets if isinstance(t, ast.Name)
                         and t.id not in scope.arrays]
                if names and self._is_array_expr(value):
                    scope.arrays.update(names)
                    grew = True

    def _known_array(self, name: str) -> bool:
        return any(name in s.arrays for s in self.scopes)

    def _is_array_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            dotted = self._dotted(node.func)
            if dotted in _ARRAY_CONSTRUCTORS or (
                    self.torch and dotted in _TORCH_ARRAY_CONSTRUCTORS):
                return True
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _ARRAY_METHODS:
                return True
            if self.torch and isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _TORCH_MOVES:
                recv = node.func.value
                return self._is_array_expr(recv) or (
                    isinstance(recv, ast.Name) and self._known_array(recv.id))
        if isinstance(node, ast.Subscript):
            return self._is_array_expr(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_array_expr(node.left) or \
                self._is_array_expr(node.right)
        return False

    def _enter_function(self, node) -> None:
        scope = _Scope(node)
        args = node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs +
                  ([args.vararg] if args.vararg else []) +
                  ([args.kwarg] if args.kwarg else [])):
            scope.bound.add(a.arg)
        self.scopes.append(scope)
        self._prescan(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.scopes[-1].bound.add(node.name)
        if any(self._is_jit_decorator(d) for d in node.decorator_list):
            self._check_jit_closure(node)
        elif self.torch and any(self._is_torch_compile(d)
                                for d in node.decorator_list):
            self._check_torch_closure(node, "torch.compile")
        if self._calls_mkstemp(node):
            self._mkstemp_funcs.add(node)
        self._enter_function(node)
        self.generic_visit(node)
        self.scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._enter_function(node)
        self.generic_visit(node)
        self.scopes.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    self.scopes[-1].bound.add(n.id)
        self.generic_visit(node)

    def _calls_mkstemp(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                dotted = self._dotted(sub.func)
                if dotted and dotted.split(".")[-1] in ("mkstemp",
                                                        "NamedTemporaryFile"):
                    return True
        return False

    # -------------------------------------------------- R004 (jit closure)

    def _is_jit_name(self, node: ast.AST) -> bool:
        dotted = self._dotted(node)
        return dotted in ("jax.jit", "jit", "jax.pjit", "pjit") or (
            dotted is not None and dotted.endswith(".jit"))

    def _is_jit_decorator(self, dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            return self._is_jit_name(dec.func)
        return self._is_jit_name(dec)

    def _is_torch_compile(self, dec: ast.AST) -> bool:
        node = dec.func if isinstance(dec, ast.Call) else dec
        return self._dotted(node) == "torch.compile"

    def _free_array_captures(self, fn) -> List[str]:
        """Names the function loads but does not bind, that an enclosing
        scope binds to an array value."""
        bound: Set[str] = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs +
                  ([args.vararg] if args.vararg else []) +
                  ([args.kwarg] if args.kwarg else [])):
            bound.add(a.arg)
        loads: List[str] = []
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    bound.add(sub.name)
                if isinstance(sub, ast.Name):
                    if isinstance(sub.ctx, (ast.Store, ast.Del)):
                        bound.add(sub.id)
                    else:
                        loads.append(sub.id)
                elif isinstance(sub, (ast.comprehension,)):
                    for n in ast.walk(sub.target):
                        if isinstance(n, ast.Name):
                            bound.add(n.id)
        captured: List[str] = []
        enclosing_arrays: Set[str] = set()
        for scope in self.scopes:
            enclosing_arrays |= scope.arrays
        for name in loads:
            if name not in bound and name in enclosing_arrays and \
                    name not in captured:
                captured.append(name)
        return captured

    def _check_jit_closure(self, fn, at: Optional[ast.AST] = None) -> None:
        for name in self._free_array_captures(fn):
            self._emit(
                "R004", at or fn,
                f"jitted function closes over array {name!r} — the value is "
                "baked into the compiled executable as a constant "
                "(uncacheable; leaks the data into the artifact). Pass it "
                "as an argument instead")

    def _check_torch_closure(self, fn, form: str,
                             at: Optional[ast.AST] = None) -> None:
        for name in self._free_array_captures(fn):
            if form == "batch_loss":
                msg = (f"batch_loss of an FL plan closes over array {name!r} "
                       "— every round reads that tensor instead of the "
                       "tenant's arguments, and the plan, cached and "
                       "shared by every tenant of its shapes, holds it. "
                       "Pass it as an argument")
            elif form == _CUDA_GRAPH_CTX:
                msg = (f"function captured under torch.cuda.graph closes "
                       f"over array {name!r} — every replay reads that "
                       "tensor's memory, and the graph holds it. Copy the "
                       "data into a static buffer before each replay")
            else:
                msg = (f"function handed to {form} closes over array "
                       f"{name!r} — what it builds reads (or bakes in) "
                       "that tensor on every call, and holds it. Pass it "
                       "as an argument (or copy it into a static buffer)")
            self._emit("R004", at or fn, msg)

    def _resolve_function(self, node: ast.AST):
        """A Lambda as is, a Name through the scopes' local defs."""
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Name):
            for scope in reversed(self.scopes):
                fn = scope.functions.get(node.id)
                if fn is not None:
                    return fn
        return None

    def _check_torch_r004_call(self, node: ast.Call,
                               dotted: Optional[str]) -> None:
        form = _TORCH_COMPILERS.get(dotted or "")
        if form is None and dotted and dotted.endswith(".graphs.capture"):
            form = "graphs.capture"
        if form is not None and node.args:
            targets = node.args[0].elts if isinstance(
                node.args[0], (ast.Tuple, ast.List)) else [node.args[0]]
            for t in targets:
                fn = self._resolve_function(t)
                if fn is not None:
                    self._check_torch_closure(fn, form, at=node)
        if dotted and dotted.split(".")[-1] in _PLAN_BUILDERS:
            fn = self._resolve_function(self._kwarg(node, "batch_loss"))
            if fn is not None:
                self._check_torch_closure(fn, "batch_loss", at=node)

    def visit_With(self, node: ast.With) -> None:
        if self.torch and any(
                isinstance(it.context_expr, ast.Call) and
                self._dotted(it.context_expr.func) == _CUDA_GRAPH_CTX
                for it in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        fn = self._resolve_function(sub.func)
                        if fn is not None:
                            self._check_torch_closure(fn, _CUDA_GRAPH_CTX,
                                                      at=sub)
        self.generic_visit(node)

    # ----------------------------------------------------------- R008 ctx

    def _is_round_loop(self, node) -> bool:
        header = node.iter if isinstance(node, ast.For) else node.test
        idents = self._idents(header)
        if isinstance(node, ast.For):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    idents.append(n.id)
        return any(_ROUNDY_RE.search(i) for i in idents)

    def visit_For(self, node: ast.For) -> None:
        self._visit_loop(node)

    def visit_While(self, node: ast.While) -> None:
        self._visit_loop(node)

    def _visit_loop(self, node) -> None:
        roundy = self._is_round_loop(node)
        if roundy:
            self._round_loop_depth += 1
        if isinstance(node, ast.For):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    self.scopes[-1].bound.add(n.id)
        self.generic_visit(node)
        if roundy:
            self._round_loop_depth -= 1

    # ------------------------------------------------------------- calls

    def _torch_sync(self, node: ast.Call, dotted: Optional[str]
                    ) -> Optional[str]:
        """The torch host-sync form of this call, if it is one."""
        if dotted == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _TORCH_SYNC_METHODS and \
                not (dotted and dotted.startswith(("numpy.", "torch."))):
            return f".{node.func.attr}()"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._dotted(node.func)
        last = dotted.split(".")[-1] if dotted else (
            node.func.attr if isinstance(node.func, ast.Attribute) else None)

        # R001 — wall clock
        if dotted == "time.time":
            self._emit("R001", node,
                       "time.time() is not monotonic — use "
                       "time.perf_counter() for timing")

        # R002 — salted builtin hash for seeds/keys
        if isinstance(node.func, ast.Name) and node.func.id == "hash" and \
                "hash" not in self._all_bound():
            self._emit("R002", node,
                       "builtin hash() is salted per process — derive "
                       "seeds/keys with zlib.crc32 or an integer mix")

        # R003 — global-state numpy RNG
        if dotted and dotted.startswith("numpy.random.") and \
                dotted.split(".")[-1] in _NP_GLOBAL_RANDOM:
            self._emit("R003", node,
                       f"np.random.{dotted.split('.')[-1]} mutates the "
                       "hidden global RandomState — use "
                       "np.random.default_rng(seed)")
        if self.torch:
            self._check_torch_r003(node, dotted)

        # R004 — jit(f) / jit(lambda …) wrapping forms
        if self._is_jit_name(node.func) and node.args:
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                self._check_jit_closure(target, at=node)
            elif isinstance(target, ast.Name):
                for scope in reversed(self.scopes):
                    fn = scope.functions.get(target.id)
                    if fn is not None:
                        self._check_jit_closure(fn, at=node)
                        break
        if self.torch:
            self._check_torch_r004_call(node, dotted)

        # R005 — float32 on counts
        self._check_r005(node, dotted, last)

        # R007 — raw checkpoint writes
        if dotted in ("numpy.save", "numpy.savez", "numpy.savez_compressed") \
                or (self.torch and dotted == "torch.save"):
            if not self._enclosing_mkstemp():
                self._emit("R007", node,
                           f"{dotted.replace('numpy', 'np')} writes the "
                           "target path directly — write via a "
                           "tempfile.mkstemp fd and os.replace into place "
                           "(checkpoint/store.py is the pattern)")

        # R008 — host syncs inside round loops / scan bodies
        if last in ("device_get", "block_until_ready") and (
                self._round_loop_depth > 0 or self._in_scan_body > 0):
            where = "a lax.scan body" if self._in_scan_body else \
                "a per-round loop"
            self._emit("R008", node,
                       f"{last} inside {where} forces one host sync per "
                       "round — batch transfers per chunk instead "
                       "(StreamedPlan streams ONE device_get per chunk)")
        if self.torch and self._round_loop_depth > 0 and \
                id(node) not in self._reported_syncs:
            sync = self._torch_sync(node, dotted)
            if sync is not None:
                # x.cpu().numpy(): one sync, reported once
                inner = node.func.value if isinstance(
                    node.func, ast.Attribute) else None
                while isinstance(inner, ast.Call):
                    self._reported_syncs.add(id(inner))
                    inner = inner.func.value if isinstance(
                        inner.func, ast.Attribute) else None
                self._emit("R008", node,
                           f"{sync} inside a per-round loop waits for the "
                           "device once a round — keep the round's results "
                           "on the device and fetch them once per chunk "
                           "(FLPlan fetches ONE loss vector per eval chunk)")

        # collect scan bodies for R008: lax.scan(body_fn, ...)
        if dotted and dotted.split(".")[-1] == "scan" and node.args and \
                isinstance(node.args[0], ast.Name):
            for scope in reversed(self.scopes):
                fn = scope.functions.get(node.args[0].id)
                if fn is not None:
                    self._flag_scan_body(fn)
                    break

        self.generic_visit(node)

    def _check_torch_r003(self, node: ast.Call,
                          dotted: Optional[str]) -> None:
        if dotted in _TORCH_GLOBAL_SEED:
            self._emit("R003", node,
                       f"{dotted} seeds the process-global generator, "
                       "which every unseeded draw in the process shares — "
                       "draw from an explicit torch.Generator "
                       "(generator=torch.Generator().manual_seed(seed))")
        elif dotted and dotted.startswith("torch.") and \
                dotted.count(".") == 1 and \
                dotted.split(".")[-1] in _TORCH_DRAWS and \
                not any(k.arg in ("generator", None) for k in node.keywords):
            self._emit("R003", node,
                       f"{dotted} without generator= draws from the "
                       "process-global generator — pass an explicit "
                       "torch.Generator")

    def _flag_scan_body(self, fn: ast.AST) -> None:
        if fn in self._scan_bodies:
            return
        self._scan_bodies.add(fn)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                last = None
                if isinstance(sub.func, ast.Attribute):
                    last = sub.func.attr
                elif isinstance(sub.func, ast.Name):
                    last = sub.func.id
                if last in ("device_get", "block_until_ready"):
                    self._emit("R008", sub,
                               f"{last} inside a lax.scan body forces a "
                               "host sync per scan step")

    def _all_bound(self) -> Set[str]:
        out: Set[str] = set()
        for s in self.scopes:
            out |= s.bound
        return out

    def _enclosing_mkstemp(self) -> bool:
        for scope in reversed(self.scopes):
            if scope.node in self._mkstemp_funcs:
                return True
            if isinstance(scope.node, ast.Module):
                # module-level write: accept a module-level mkstemp call
                return self._calls_mkstemp(scope.node)
        return False

    # ----------------------------------------------------------- R005/R006

    def _county(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name) and _COUNTY_RE.search(node.id):
            return node.id
        if isinstance(node, ast.Attribute) and _COUNTY_RE.search(node.attr):
            return node.attr
        return None

    def _is_f32(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) and node.value == "float32":
            return True
        dotted = self._dotted(node)
        return dotted in _F32_NAMES or (self.torch and
                                        dotted in _TORCH_F32_NAMES)

    def _check_r005(self, node: ast.Call, dotted: Optional[str],
                    last: Optional[str]) -> None:
        flag: Optional[str] = None
        # x.astype(np.float32)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "astype" and node.args and \
                self._is_f32(node.args[0]):
            flag = self._county(node.func.value)
        # np.float32(x)
        elif dotted in _F32_NAMES and node.args:
            flag = self._county(node.args[0])
        # np.asarray(x, np.float32) / np.array(x, dtype=np.float32)
        # (torch: torch.tensor / torch.as_tensor)
        elif (dotted in ("numpy.asarray", "numpy.array", "jax.numpy.asarray",
                         "jax.numpy.array") or
              (self.torch and dotted in ("torch.tensor", "torch.as_tensor"))) \
                and node.args:
            dt = node.args[1] if len(node.args) > 1 else \
                self._kwarg(node, "dtype")
            if dt is not None and self._is_f32(dt):
                flag = self._county(node.args[0])
        # torch: x.float() / x.to(torch.float32)
        elif self.torch and isinstance(node.func, ast.Attribute) and (
                (node.func.attr == "float" and not node.args) or
                (node.func.attr == "to" and any(
                    self._is_f32(a) for a in
                    node.args + [k.value for k in node.keywords
                                 if k.arg == "dtype"]))):
            flag = self._county(node.func.value)
        if flag:
            self._emit("R005", node,
                       f"float32 cast on sample count {flag!r} — float32 "
                       "collapses integers above 2^24; keep counts "
                       "integral, normalize in float64, cast the "
                       "normalized result")

    def _weighty(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name) and (
                node.id in _WEIGHTY or _WEIGHTY_RE.search(node.id)):
            return node.id
        if isinstance(node, ast.Attribute) and (
                node.attr in _WEIGHTY or _WEIGHTY_RE.search(node.attr)):
            return node.attr
        return None

    def _weight_sum(self, node: ast.AST) -> Optional[str]:
        """Is this expression a sum over a weight/mask vector?"""
        if not isinstance(node, ast.Call):
            return None
        # np.sum(w) / jnp.sum(w) / sum(w) — check the argument form first:
        # jnp.sum(weights) also parses as <receiver>.sum(), and the receiver
        # (a module alias) is never weighty, so the attribute form must not
        # preempt it
        dotted = self._dotted(node.func)
        if dotted and dotted.split(".")[-1] == "sum" and node.args:
            got = self._weighty(node.args[0])
            if got is not None:
                return got
        if isinstance(node.func, ast.Name) and node.func.id == "sum" and \
                node.args:
            got = self._weighty(node.args[0])
            if got is not None:
                return got
        # w.sum() / w.sum(axis=...)
        if isinstance(node.func, ast.Attribute) and node.func.attr == "sum":
            return self._weighty(node.func.value)
        return None

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Div):
            den = node.right
            name = self._weight_sum(den)
            if name is not None:
                self._emit(
                    "R006", node,
                    f"division by sum({name}) without an eps guard — zero "
                    "weight mass NaNs; wrap as maximum(sum, eps<=1e-6) "
                    "(cf. federated._DEN_EPS)")
            else:
                # maximum(sum(w), BIG): the deflation bug — a clamp
                # constant >= 1 silently deflates at fractional mass
                guard = self._guarded_weight_sum(den)
                if guard is not None:
                    gname, eps = guard
                    if eps is not None and eps > 1e-6:
                        self._emit(
                            "R006", node,
                            f"maximum(sum({gname}), {eps!r}) deflates the "
                            "mean whenever the real weight mass is below "
                            f"{eps!r} — use a tiny eps (<=1e-6, cf. "
                            "federated._DEN_EPS)")
                elif self.torch:
                    guard = self._clamped_weight_sum(den)
                    if guard is not None and guard[1] is not None and \
                            guard[1] > 1e-6:
                        gname, eps = guard
                        self._emit(
                            "R006", node,
                            f"clamp(sum({gname}), min={eps!r}) deflates "
                            "the mean whenever the real weight mass is "
                            f"below {eps!r} — clamp at a tiny eps (<=1e-6, "
                            "cf. federated._DEN_EPS)")
        self.generic_visit(node)

    def _guarded_weight_sum(self, node: ast.AST):
        """maximum(sum(w), c) → (name, c) with c=None for non-constant."""
        if not (isinstance(node, ast.Call) and len(node.args) == 2):
            return None
        dotted = self._dotted(node.func)
        last = dotted.split(".")[-1] if dotted else (
            node.func.id if isinstance(node.func, ast.Name) else None)
        if last not in ("maximum", "max"):
            return None
        name = self._weight_sum(node.args[0])
        if name is None:
            return None
        c = node.args[1]
        eps = float(c.value) if isinstance(c, ast.Constant) and \
            isinstance(c.value, (int, float)) else None
        return name, eps

    def _clamped_weight_sum(self, node: ast.AST):
        """torch: clamp(sum(w), min=c) / clamp(sum(w), c) /
        clamp_min(sum(w), c) / sum(w).clamp(min=c) / sum(w).clamp_min(c)
        → (name, c) with c=None for non-constant."""
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in ("clamp", "clamp_min"):
            return None
        dotted = self._dotted(node.func)
        if dotted in ("torch.clamp", "torch.clamp_min"):
            if not node.args:
                return None
            summed, rest = node.args[0], node.args[1:]
        else:
            summed, rest = node.func.value, node.args
        name = self._weight_sum(summed)
        if name is None:
            return None
        c = rest[0] if rest else self._kwarg(node, "min")
        return name, _const_number(c)


def lint_source(source: str, path: str = "<string>") -> List[Violation]:
    """Lint one module's source; returns the violations that survive the
    `# feddcl-lint: disable=` directives."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(rule="E000", path=path, line=e.lineno or 0,
                          col=e.offset or 0,
                          message=f"syntax error: {e.msg}")]
    linter = _Linter(source, path)
    linter.visit(tree)
    per_line, whole_file = _parse_disables(source)
    out = []
    for v in linter.violations:
        if v.rule in whole_file or "ALL" in whole_file:
            continue
        rules_here = per_line.get(v.line, set()) | per_line.get(v.line - 1,
                                                               set())
        if v.rule in rules_here or "ALL" in rules_here:
            continue
        out.append(v)
    return out


def lint_file(path: str) -> List[Violation]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


_SKIP_DIRS = {"__pycache__", ".git", ".claude", "results", "node_modules"}


def iter_python_files(roots: Sequence[str]) -> Iterable[str]:
    for root in roots:
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(roots: Sequence[str]) -> List[Violation]:
    out: List[Violation] = []
    for path in iter_python_files(roots):
        out.extend(lint_file(path))
    return out


def violations_json(violations: Sequence[Violation],
                    files_checked: int = 0) -> str:
    return json.dumps({
        "tool": "feddcl_lint",
        "rules": RULES,
        "files_checked": files_checked,
        "violation_count": len(violations),
        "violations": [asdict(v) for v in violations],
    }, indent=1)


# ---------------------------------------------------------------- the CLI

REPO_ROOT = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir, os.pardir, os.pardir))


def _imports_port(path: str) -> bool:
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return False
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "repro_torch" for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "repro_torch":
            return True
    return False


def default_roots(repo_root: str = REPO_ROOT) -> List[str]:
    """The port's surfaces: the package, ``chip_smoke.py`` and the scripts
    under ``scripts/`` that import ``repro_torch``."""
    roots = [os.path.join(repo_root, "src", "repro_torch"),
             os.path.join(repo_root, "chip_smoke.py")]
    scripts = os.path.join(repo_root, "scripts")
    if os.path.isdir(scripts):
        roots += [p for p in iter_python_files([scripts]) if _imports_port(p)]
    return [r for r in roots if os.path.exists(r)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST lint of the port (rules R001–R008)")
    ap.add_argument("roots", nargs="*", default=None,
                    help="files/directories to lint (default: "
                         "src/repro_torch, chip_smoke.py and the scripts "
                         "that import repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to report "
                         "(default: all)")
    args = ap.parse_args(argv)

    roots = args.roots or default_roots()
    if not roots:
        print("feddcl_lint: no lintable roots found", file=sys.stderr)
        return 2
    only = None
    if args.rules:
        only = {r.strip().upper() for r in args.rules.split(",") if r.strip()}
        unknown = only - set(RULES)
        if unknown:
            print(f"feddcl_lint: unknown rule(s) {sorted(unknown)}; "
                  f"known: {sorted(RULES)}", file=sys.stderr)
            return 2

    files = list(iter_python_files(roots))
    violations = []
    for path in files:
        for v in lint_file(path):
            if only is None or v.rule in only:
                # paths relative to the repo root, for stable output
                v.path = os.path.relpath(v.path, REPO_ROOT) \
                    if os.path.isabs(v.path) else v.path
                violations.append(v)

    if args.json:
        print(violations_json(violations, files_checked=len(files)))
    else:
        for v in violations:
            print(v.format())
        print(f"feddcl_lint: {len(violations)} violation(s) in "
              f"{len(files)} file(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
