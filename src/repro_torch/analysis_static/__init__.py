"""planlint on the port: static plan / beat / kernel verification for the
shared heartbeat, the counterpart of the JAX package's
``repro.analysis_static`` with the same rule ids and findings.

SharedDB's value proposition is *predictability*: one always-on plan
whose per-beat cost is bounded by construction.  The invariants that
boundedness rests on — disjoint admission slot ranges, in-window scatter
plans, partition geometry wide enough for the measured key skew,
prefix-stable folds, no full-width compare on the steady-state path,
fixed beat buffers that no in-flight slot shares — are each a named lint
rule (``registry``) that one analyzer proves for any lowered plan:

  * ``ir_passes``     — structural checks over ``CompiledPlan`` + the
                        staged lowering IR (``LoweredPlan``), including
                        the fold-admission and prefix-stability rules
                        that ``folding.extend_plan`` and
                        ``SharedDBEngine.begin_fold`` route through.
                        Cheap, host only: run always-on at engine
                        construction and in every fold build.
  * ``trace_passes``  — record what the full / delta / delta-join bodies
                        run (a dispatch-mode recorder on the ``torch``
                        backend): width classifier, donation contract,
                        disjoint fixed buffers.
  * ``kernel_passes`` — static validation of the fused_delta kernel's
                        launch descriptor (coverage, gather bounds, grid
                        and compiled bounds, one writer per output).
  * ``source_passes`` — ``no-bare-assert``: hot-path modules must guard
                        with real raises, never ``assert`` (stripped
                        under ``python -O``).

``python -m repro_torch.analysis_static.lint`` sweeps workloads x
backends and exits non-zero on any error-severity finding; the seeded
mutation corpus under ``tests/torch_lint_corpus/`` proves each rule the
port proves actually fires.  Imports torch and numpy, never jax.
"""
from repro_torch.analysis_static.diagnostics import (LintFinding,
                                                     PlanLintError,
                                                     errors_in,
                                                     format_findings,
                                                     raise_on_error)
from repro_torch.analysis_static.registry import RULES, Rule, all_rules

__all__ = [
    "LintFinding", "PlanLintError", "errors_in", "format_findings",
    "raise_on_error", "RULES", "Rule", "all_rules",
]
