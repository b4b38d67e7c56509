from repro_torch.configs.base import (
    REGISTRY,
    AttnConfig,
    ModelConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["REGISTRY", "AttnConfig", "ModelConfig", "get_config",
           "list_archs", "register"]
