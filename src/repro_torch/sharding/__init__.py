"""The port's partition plan: logical axes -> PartitionSpec over a mesh."""
from repro_torch.sharding.partitioning import (  # noqa: F401
    DEFAULT_RULES,
    ParallelPlan,
    PartitionSpec,
    to_pspec,
    tree_to_pspecs,
    validate_pspec,
    zero1_pspec,
)
