from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    current_rules,
    shard,
    use_rules,
)

__all__ = ["DEFAULT_RULES", "ShardingRules", "current_rules", "shard",
           "use_rules"]
