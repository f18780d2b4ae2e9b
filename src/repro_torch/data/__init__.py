from repro_torch.data.pipeline import (HostShardedLoader, Prefetcher,
                                       SyntheticImages, SyntheticLM)

__all__ = ["SyntheticLM", "SyntheticImages", "HostShardedLoader", "Prefetcher"]
