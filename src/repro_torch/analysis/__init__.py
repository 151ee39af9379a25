"""Audits of the port's built plans (counterpart of ``repro.analysis``):
``hlo_audit``'s build counter and no-baked-data check. The reference's
lint (rules R001–R008) is not ported yet (ROADMAP.md, Queue 1 item 4)."""
from repro_torch.analysis.hlo_audit import (BakedDataError, CompileCounter,
                                            assert_no_baked_data,
                                            collective_census)

__all__ = ["BakedDataError", "CompileCounter", "assert_no_baked_data",
           "collective_census"]
