"""The execution pipeline's result types.

Only :mod:`repro_torch.core.exec.assemble`'s :class:`ScenarioResult` is
ported so far: the single-observer path needs nothing else.  The plan,
program, fence, dispatch, resilience and journal stages of the JAX
package's ``core/exec`` wait for the multi-engine contention path.
"""
from repro_torch.core.exec.assemble import ScenarioResult  # noqa: F401
