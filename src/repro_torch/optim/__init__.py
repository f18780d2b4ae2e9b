from repro_torch.optim.compression import (compress, compressed_allreduce,
                                           decompress_and_update_error,
                                           init_error_state)
from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd_momentum)
from repro_torch.optim.quantized import (QLeaf, QuantizedMoments,
                                         dequantize_moments, quantize_moments)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm", "sgd_momentum", "cosine_schedule", "linear_warmup",
           "QLeaf", "QuantizedMoments", "quantize_moments",
           "dequantize_moments", "init_error_state", "compress",
           "decompress_and_update_error", "compressed_allreduce"]
