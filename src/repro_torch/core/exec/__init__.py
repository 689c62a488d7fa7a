"""The spmd execution pipeline: plan -> build -> dispatch -> assemble.

One stage per module, each consuming the previous stage's declarative
output, the JAX package's ``core/exec`` module for module:

* :mod:`repro_torch.core.exec.plan` — (specs -> triples -> signature
  groups) as a :class:`DispatchPlan` of :class:`PlannedDispatch`es, the
  pure planner transforms (engine-subset width-packing, probe batches),
  and :func:`observer_groups` for the ``cuda`` backend's measured pass.
* :mod:`repro_torch.core.exec.program` — role descriptors, operand
  construction, barrier layouts, and :func:`build_ladder_entry`
  producing a :class:`CompiledProgram` for the contention ladder kernel.
* :mod:`repro_torch.core.exec.fence` — the fence check from each
  launch's stamps (:func:`measured_region_is_fenced`), packed-subset
  aware.
* :mod:`repro_torch.core.exec.dispatch` — the program/operand LRU, the
  launch, and the (waves, subsets, rungs, samples) clock decode;
  :class:`DispatchStats`.
* :mod:`repro_torch.core.exec.assemble` — ScenarioRun /
  execution-provenance construction from the results.
* :mod:`repro_torch.core.exec.resilience` — fault injection, retry with
  the packed->batched->ladder->rung->modeled degradation ladder, and the
  per-rung measurement quality gate.
* :mod:`repro_torch.core.exec.journal` — sweep-level resilient plan
  execution and the crash-resume :class:`SweepJournal`.

``CoreCoordinator`` (repro_torch.core.coordinator) is the thin facade
over this package.
"""
from repro_torch.core.exec.assemble import (MatrixResult, ScenarioResult,
                                            ScenarioRun, assemble_runs,
                                            observer_result)
from repro_torch.core.exec.dispatch import (Dispatcher, DispatchStats,
                                            ProgramCache)
from repro_torch.core.exec.fence import (groups_isolate,
                                         measured_region_is_fenced,
                                         stamps_fenced)
from repro_torch.core.exec.journal import (SweepJournal, entry_key,
                                           execute_plan, execute_rung_path,
                                           plan_fingerprint)
from repro_torch.core.exec.plan import (DispatchPlan, LadderEntry,
                                        PlannedDispatch, build_plan,
                                        effective_duty, group_key,
                                        ladder_depth, observer_groups,
                                        operand_kind, pack_engine_subsets,
                                        probe_batch, rung_roles, rung_row,
                                        split_ladders, split_probes,
                                        unpack_dispatch)
from repro_torch.core.exec.program import (CompiledProgram,
                                           build_ladder_entry,
                                           build_program,
                                           build_rung_operands,
                                           build_scenario_program,
                                           role_descriptor)
from repro_torch.core.exec.resilience import (FaultInjector, FaultSpec,
                                              GroupExecutionError,
                                              InjectedFault, QualityGate,
                                              RetryPolicy, resolve_faults,
                                              resolve_gate, run_group)

__all__ = [
    "MatrixResult", "ScenarioResult", "ScenarioRun", "assemble_runs",
    "observer_result", "Dispatcher", "DispatchStats", "ProgramCache",
    "groups_isolate", "measured_region_is_fenced", "stamps_fenced",
    "DispatchPlan", "LadderEntry", "PlannedDispatch", "build_plan",
    "effective_duty", "group_key", "ladder_depth", "observer_groups",
    "operand_kind", "pack_engine_subsets", "probe_batch", "rung_roles",
    "rung_row", "split_ladders", "split_probes", "unpack_dispatch",
    "CompiledProgram", "build_ladder_entry", "build_program",
    "build_rung_operands", "build_scenario_program", "role_descriptor",
    "FaultInjector", "FaultSpec", "GroupExecutionError", "InjectedFault",
    "QualityGate", "RetryPolicy", "resolve_faults", "resolve_gate",
    "run_group", "SweepJournal", "entry_key", "execute_plan", "execute_rung_path",
    "plan_fingerprint",
]
