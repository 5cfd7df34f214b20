from repro_torch.models.api import (decode_step, init_model, pad_cache,
                                    prefill)
from repro_torch.models.backbone import ModelConfig

__all__ = ["ModelConfig", "decode_step", "init_model", "pad_cache", "prefill"]
