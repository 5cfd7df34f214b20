"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small. [hf:HuggingFaceTB/SmolLM-360M]
"""

from repro_torch.configs._common import DENSE_TARGETS, FULL, SMOKE
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "smollm-360m", "family": "dense",
        "long_500k": False, "decode": True}
PEFT_TARGETS = DENSE_TARGETS


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv=5,
        d_ff=2560, vocab=49152, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", n_layers=4, d_model=96, n_heads=3, n_kv=1,
        d_ff=256, vocab=512, **SMOKE)
