"""Multi-tenant collaboration serving (counterpart of ``repro.serve_collab``):
heterogeneous x → f_j(x) G_j → h requests queued, bucketed by (group, pow2
batch width), and served by one resident step per shape bucket through the
shared PlanCache (on CUDA, one captured graph per bucket) — plus
incremental onboarding of users/silos onto a live server."""
from repro_torch.serve_collab.server import (CollabRequest, ServeCollab,
                                             ServeOutput, serve_step)
from repro_torch.serve_collab.tables import (TenantTable, build_table,
                                             build_tables, combined_user_map)

__all__ = [
    "CollabRequest", "ServeCollab", "ServeOutput", "serve_step",
    "TenantTable", "build_table", "build_tables", "combined_user_map",
]
