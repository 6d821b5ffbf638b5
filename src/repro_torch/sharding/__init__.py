from repro_torch.sharding.rules import (  # noqa: F401
    MeshRules, current_rules, use_rules,
    TRAIN_RULES, DECODE_RULES, param_shardings,
)
