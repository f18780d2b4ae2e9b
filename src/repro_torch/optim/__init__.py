from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd_momentum)
from repro_torch.optim.quantized import (QLeaf, QuantizedMoments,
                                         dequantize_moments, quantize_moments)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm", "sgd_momentum", "cosine_schedule", "linear_warmup",
           "QLeaf", "QuantizedMoments", "quantize_moments",
           "dequantize_moments"]
