"""The port's optimizer (`adamw`) and the error-feedback int8 gradient
compression of the data-parallel all-reduce (`compression`)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, cosine_schedule,
                                     global_norm)
from repro_torch.optim.compression import (CompressionState,
                                           compress_grads_init,
                                           compressed_allreduce)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "CompressionState",
           "compress_grads_init", "compressed_allreduce"]
