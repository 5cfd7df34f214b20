"""Llama-2-7B — the paper's instruction-tuning model (§5.2.2, Table 5):
32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000.
"""

from repro_torch.configs._common import DENSE_TARGETS, FULL, SMOKE
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "llama-2-7b", "family": "dense",
        "long_500k": False, "decode": True}
PEFT_TARGETS = DENSE_TARGETS


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-2-7b", n_layers=32, d_model=4096, n_heads=32, n_kv=32,
        d_ff=11008, vocab=32000, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama2-smoke", n_layers=4, d_model=128, n_heads=4, n_kv=4,
        d_ff=344, vocab=512, **SMOKE)
