from repro_torch.optim.schedules import constant, cosine, wsd
from repro_torch.optim.transforms import (GradientTransformation,
                                          add_decayed_weights, adamw,
                                          apply_updates, chain,
                                          clip_by_global_norm, global_norm,
                                          scale_by_adam, scale_by_schedule)

__all__ = ["GradientTransformation", "add_decayed_weights", "adamw",
           "apply_updates", "chain", "clip_by_global_norm", "constant",
           "cosine", "global_norm", "scale_by_adam",
           "scale_by_schedule", "wsd"]
