"""Rule registry. Adding a rule = subclass
:class:`repro_torch.analysis.lint.Rule` in a module here and list it in
:data:`RULES`."""
from repro_torch.analysis.rules.graph_capture import GraphCaptureRule
from repro_torch.analysis.rules.host_sync import HostSyncRule
from repro_torch.analysis.rules.mesh_api import MeshApiRule
from repro_torch.analysis.rules.multi_sync import MultiSyncRule
from repro_torch.analysis.rules.silent_fallback import SilentFallbackRule

RULES = [MeshApiRule, GraphCaptureRule, HostSyncRule, MultiSyncRule,
         SilentFallbackRule]


def all_rules():
    return [cls() for cls in RULES]
