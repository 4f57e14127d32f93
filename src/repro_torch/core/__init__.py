"""targetDP core in PyTorch: the paper's abstraction layer, for one GPU.

Layout (INDEX macro)  ->  core.layout
Field, BatchedField   ->  core.field
Lowering plans (VVL)   ->  core.plan
Engines / launch       ->  core.target   (engine "torch" or "cuda")
Reductions             ->  core.reduce   (targetDoubleSum ...)
Stencils               ->  core.stencil
Kernel fusion          ->  core.fuse     (LaunchGraph)
Plan autotuner         ->  core.tune     (plan_policy="tuned")
Halo exchange          ->  core.halo     (torch.distributed; a side stream)
Comms/compute overlap  ->  core.overlap  (halo="overlap")
"""

from .layout import (  # noqa: F401
    AOS, SOA, Layout, LayoutKind, aosoa, parse_layout, tileable_layout,
)
from .field import BatchedField, Field  # noqa: F401
from .plan import DtypePolicy, LoweringPlan, choose_vvl  # noqa: F401
from .target import TargetConfig, TargetKernel, kernel, launch  # noqa: F401
from .reduce import target_max, target_sum  # noqa: F401
from .fuse import BoundLaunch, LaunchGraph, ReduceSpec  # noqa: F401
from . import halo, overlap, plan, stencil  # noqa: F401
from .overlap import overlap_launch  # noqa: F401
