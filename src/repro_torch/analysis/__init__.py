"""Static analysis and artifact audits of the port (counterpart of
``repro.analysis``).

- ``repro_torch.analysis.lint`` — stdlib-only AST lint (rules R001–R008,
  each a past regression, with its torch forms beside the JAX ones),
  driven by ``python -m repro_torch.analysis.lint``.
- ``repro_torch.analysis.hlo_audit`` — audits of what the port builds:
  the build counter, the no-baked-data check (behavioural, then the
  structural ``find_baked_constants`` over an idle plan).
- ``python -m repro_torch.analysis.audit`` — the single-card checks of the
  reference's ``scripts/feddcl_audit.py``.

Loaded lazily, so the lint runs without torch.
"""
import importlib

_NAMES = {
    "RULES": "lint", "Violation": "lint", "lint_file": "lint",
    "lint_paths": "lint", "lint_source": "lint", "violations_json": "lint",
    "BakedDataError": "hlo_audit", "CompileCounter": "hlo_audit",
    "assert_no_baked_data": "hlo_audit", "collective_census": "hlo_audit",
    "find_baked_constants": "hlo_audit",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        module = importlib.import_module(f"{__name__}.{_NAMES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
