"""Static invariant analyzer: AST lint rules, grid audit, retrace sentinel,
as ``repro.analysis``.

Three layers, one CLI (``python -m repro_torch.analysis``):

1. **AST invariant linter** (:mod:`repro_torch.analysis.lint` +
   :mod:`repro_torch.analysis.rules`): pluggable rules over
   ``src/repro_torch`` that hold the port to the serving system's honesty
   contract: ``torch.distributed`` only in the mesh module, graph capture
   and compilation only where ``core.graphs`` counts them, host syncs
   only at annotated points, and no silent kernel fallbacks.
2. **Grid auditor** (:mod:`repro_torch.analysis.trace_audit`): every
   arch × serving mesh shape either yields a ``kernel_partition_plan``
   and divides under ``Rules`` or raises the documented divisibility
   error, and every engine stage runs on meta tensors at the audit
   geometry. No devices, CPU-fast.
3. **Retrace sentinel** (:mod:`repro_torch.analysis.retrace`): audits an
   Engine's stage-entry build counters (``EngineStats.compile_counts``:
   the CUDA graphs captured on the card, the entries built eagerly
   elsewhere) against a zero-post-warmup budget.

The rules, and the reference's each one stands for:

=================  ==================  =================================
port rule          reference rule      holds
=================  ==================  =================================
``mesh-api``       ``mesh-api``        ``torch.distributed`` only in
                                       ``launch/mesh.py``
``graph-capture``  ``bare-jit``        ``torch.cuda.graph`` /
                                       ``CUDAGraph`` / ``torch.compile``
                                       only in ``core/graphs.py``, which
                                       counts captures
``host-sync``      ``host-sync``       ``.item()``, ``.tolist()``,
                                       ``.cpu()``, ``.numpy()``,
                                       ``synchronize()`` only annotated
``multi-sync``     ``multi-sync``      at most one sync a function
``silent-          ``silent-           kernel and footprint flag branches
fallback``         fallback``          raise or bill
(none)             ``donation``        torch has no buffer donation: an
                                       input is never handed to a
                                       program to overwrite, so there is
                                       no aliasing or use-after-donate to
                                       check
=================  ==================  =================================
"""
from repro_torch.analysis.lint import Finding, LintReport, run_lint  # noqa: F401
from repro_torch.analysis.retrace import RetraceReport, check_engine  # noqa: F401
from repro_torch.analysis.trace_audit import AuditReport, run_grid_audit  # noqa: F401
