"""MEMSCOPE core — the paper's contribution as a composable subsystem.

devicetree   platform description + auto-detect (DTB analog)
pools        Memory Pool Manager (genpool analog) + upool export
workloads    Workload Library (Table I strategies over the CUDA kernels)
scenarios    declarative scenario DSL (traffic shapes, observers, stressors)
simulate     closed queueing-network model of the contended rungs
coordinator  Core Coordinator: validate, measure the observer, model rungs,
             or execute them (spmd); run_matrix over scenario matrices
             (exec/ pipeline)
characterize performance curves + surfaces + Little's-law MLP (CurveDB)
placement    characterization-driven Placement Advisor (upool payoff)
counters     performance-counter analog
interface    debugfs-style entries + CLI
convert      platform trees and buffers carried over from the JAX package
"""
from repro_torch.core.coordinator import (  # noqa: F401
    ActivitySpec, CoreCoordinator, ExperimentConfig, ExperimentResult,
    ValidationError)
from repro_torch.core.devicetree import Platform, detect_platform  # noqa: F401
from repro_torch.core.pools import PoolManager  # noqa: F401
