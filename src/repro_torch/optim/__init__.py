"""The port's optimizer (`adamw`).  The reference's `optim/compression.py`
(the gradient compression of its data-parallel all-reduce) waits for
training on the mesh (ROADMAP queue 1 step 9c)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
