"""The execution pipeline of the matrix runner: plan -> measure -> assemble.

* :mod:`repro_torch.core.exec.plan` — signature groups of the measured
  observer pass (:func:`observer_groups`), ladder depth, duty guard.
* :mod:`repro_torch.core.exec.dispatch` — :class:`DispatchStats`, the
  accounting ``run_matrix`` returns and CurveDB records.
* :mod:`repro_torch.core.exec.assemble` — ScenarioResult / ScenarioRun /
  MatrixResult construction and the ``execution`` provenance.

The program, fence, dispatch, resilience and journal stages of the JAX
package's ``core/exec`` wait for the multi-engine contention path.
"""
from repro_torch.core.exec.assemble import (MatrixResult, ScenarioResult,
                                            ScenarioRun, assemble_runs)
from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.core.exec.plan import (effective_duty, ladder_depth,
                                        observer_groups)

__all__ = [
    "MatrixResult", "ScenarioResult", "ScenarioRun", "assemble_runs",
    "DispatchStats", "effective_duty", "ladder_depth", "observer_groups",
]
