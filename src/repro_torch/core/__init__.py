"""PolyTOPS: configurable, flexible polyhedral scheduler (CGO 2024), the
port's own copy of the reference's scheduling path (pure Python).

Public API:

    from repro_torch.core import Scop, schedule_scop, config

    k = Scop("gemm", params={"N": 512})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            with k.loop("kk", 0, "N"):
                k.stmt("C[i,j] = C[i,j] + A[i,kk] * B[kk,j]")
    sched = schedule_scop(k, config.tensor_style())
    print(sched.pretty())

Code generation: one schedule-tree IR (repro_torch.core.schedtree) feeds
every backend — repro_torch.core.codegen (numpy), repro_torch.core.cbackend
(C, measured by the autotuner through repro_torch.core.crunner), and
repro_torch.core.akg.lower_to_kernel_plan (the Hopper kernels' plans).
"""
from . import config
from .config import (DimConfig, Directive, FusionSpec, SchedulerConfig,
                     bigloops_style, feautrier_style, isl_style, pluto_style,
                     tensor_style)
from .deps import compute_dependences
from .schedcache import ScheduleCache, cached_schedule_scop
from .scheduler import PolyTOPSScheduler, Schedule, SchedulingError, schedule_scop
from .scop import Scop

__all__ = [
    "Scop", "schedule_scop", "cached_schedule_scop", "ScheduleCache",
    "PolyTOPSScheduler", "Schedule",
    "SchedulingError", "SchedulerConfig", "DimConfig", "Directive",
    "FusionSpec", "compute_dependences", "config", "pluto_style",
    "tensor_style", "isl_style", "feautrier_style", "bigloops_style",
]
