"""Distribution substrate (port of ``repro/distributed``): sharding rules, the
data-parallel train step with an explicit, optionally int8-compressed
gradient reduction, and the GPipe pipeline."""

from repro_torch.models.params import ShardingRules, shardings, specs, spec_for
from repro_torch.distributed.dp import make_dp_train_step
from repro_torch.distributed.pipeline import pipeline_forward

__all__ = [
    "ShardingRules",
    "shardings",
    "specs",
    "spec_for",
    "make_dp_train_step",
    "pipeline_forward",
]
