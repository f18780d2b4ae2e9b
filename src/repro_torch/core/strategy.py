"""Parallelism strategies — the paper's {DP, MP, HP} as sharding policies."""
from __future__ import annotations

import enum


class Strategy(str, enum.Enum):
    DP = "DP"    # replicate weights; batch over `data`; compute replicated on `model`
    MP = "MP"    # tensor/expert/head-parallel over `model`; batch over `data`
    HP = "HP"    # MP over `model` + ZeRO-3/FSDP weight sharding over `data`
    FS = "FS"    # fully-sharded (ZeRO-3 over ALL axes): batch over data x model,
                 # weights gathered per layer — beyond-paper strategy (§Perf);
                 # uniform-only (batch layout must be globally consistent)

    def __str__(self):
        return self.value


# the paper's strategy set (mixed assignments draw from these)
ALL_STRATEGIES = (Strategy.DP, Strategy.MP, Strategy.HP)
# uniform/static candidates additionally include FS
UNIFORM_STRATEGIES = (Strategy.DP, Strategy.MP, Strategy.HP, Strategy.FS)

# strategies ordered by per-device parameter memory (most -> least)
MEMORY_ORDER = (Strategy.DP, Strategy.MP, Strategy.HP, Strategy.FS)
