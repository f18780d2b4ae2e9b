from repro_torch.data.pipeline import HostShardedLoader, Prefetcher, SyntheticLM

__all__ = ["SyntheticLM", "HostShardedLoader", "Prefetcher"]
