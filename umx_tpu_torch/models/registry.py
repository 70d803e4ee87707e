"""Model-family registry (counterpart of ``umx_tpu.models.registry``).

The reference hardcodes two families selected by file contents
(hidden_size 1024 = UMX-L, 512 = UMX-HQ; model.cpp:109-114).  The
registry names them, carries their engine presets over the port's
``EngineConfig``, and gives tests and tools one place to enumerate the
supported families.
"""

from __future__ import annotations

from dataclasses import dataclass

from umx_tpu_torch.config import EngineConfig, ModelConfig


@dataclass(frozen=True)
class ModelFamily:
    name: str
    hidden_size: int
    description: str

    def engine_config(self, **overrides) -> EngineConfig:
        cfg = EngineConfig(model=ModelConfig(hidden_size=self.hidden_size))
        return cfg.replace(**overrides) if overrides else cfg


REGISTRY: dict[str, ModelFamily] = {
    "umxl": ModelFamily("umxl", 1024, "Open-Unmix UMX-L (trained on extra data)"),
    "umxhq": ModelFamily("umxhq", 512, "Open-Unmix UMX-HQ (MUSDB18-HQ)"),
}


def family_for_hidden_size(hidden_size: int) -> ModelFamily:
    for fam in REGISTRY.values():
        if fam.hidden_size == hidden_size:
            return fam
    return ModelFamily(f"umx-h{hidden_size}", hidden_size, "custom UMX variant")


def get(name: str) -> ModelFamily:
    if name not in REGISTRY:
        raise KeyError(f"unknown model family {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
