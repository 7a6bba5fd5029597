"""fps_tpu_torch.analysis — the program contract auditor.

Port of ``fps_tpu/analysis/`` (see ``docs/analysis.md``), at two
altitudes:

* **program passes** — the port runs no compiled program, so its
  counterpart of lowering is a :class:`ProgramRecord` of one eager call of
  the step loop (:mod:`fps_tpu_torch.analysis.record`): its collectives,
  kernel launches, host transfers, donated tables and float widths. The
  pass suite (:mod:`fps_tpu_torch.analysis.passes`) certifies a record, or
  a StableHLO module of the JAX package (:class:`HloProgram`), against a
  :class:`ProgramContract`. ``Trainer(audit=...)`` certifies the first
  call of every program it runs; ``Trainer.lowered_chunk_text`` and
  ``lowered_megastep_text`` return a record's text;
  ``fps_tpu_torch/examples/audit_programs.py`` certifies the example
  workloads.
* **source linter** — :mod:`fps_tpu_torch.analysis.lint` catches the
  source hazards that make wrong programs (late-bound closures over loop
  variables, bool branches on tensor predicates, blocking host work on the
  training thread, ...); ``fps_tpu_torch/examples/lint.py`` runs it and a
  tier-1 test keeps the package at zero findings.

Neither torch nor jax is imported here: the modules parse text and source
(the recording imports torch when it runs). ``fps_tpu_torch/__init__``
imports torch, so on a host without it the command lines load this
package through a stub root.
"""

from fps_tpu_torch.analysis.contract import (
    Certificate,
    ContractViolationError,
    ProgramAuditor,
    ProgramContract,
    Violation,
    as_auditor,
    certify,
    contract_for_trainer,
)
from fps_tpu_torch.analysis.hlo import (
    Collective,
    HloOp,
    HloProgram,
    collective_profile,
    count_collectives,
)
from fps_tpu_torch.analysis.lint import LintFinding, lint_paths, lint_source
from fps_tpu_torch.analysis.passes import (
    DEFAULT_PASSES,
    AnalysisPass,
    CollectiveBudget,
    DonationAudit,
    DtypeDriftDetector,
    HostTransferDetector,
    ReplicaConsistency,
)
from fps_tpu_torch.analysis.record import ProgramRecord, RecordOp

__all__ = [
    "HloProgram", "HloOp", "Collective",
    "collective_profile", "count_collectives",
    "ProgramContract", "Violation", "Certificate",
    "ContractViolationError", "ProgramAuditor", "as_auditor",
    "certify", "contract_for_trainer",
    "AnalysisPass", "CollectiveBudget", "HostTransferDetector",
    "DonationAudit", "DtypeDriftDetector", "ReplicaConsistency",
    "DEFAULT_PASSES",
    "LintFinding", "lint_source", "lint_paths",
    "ProgramRecord", "RecordOp",
]
