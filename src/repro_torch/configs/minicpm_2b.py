"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753, WSD learning-rate schedule (arch llama-like).
[arXiv:2404.06395; hf]
long_500k SKIPPED (full attention).  The WSD (warmup-stable-decay)
schedule is ``repro_torch.optim.schedules.wsd`` (``--schedule wsd``);
``TRAIN_SCHEDULE`` names it, as the JAX package's config module does.
"""

from repro_torch.configs._common import DENSE_TARGETS, FULL, SMOKE
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "minicpm-2b", "family": "dense",
        "long_500k": False, "decode": True}
PEFT_TARGETS = DENSE_TARGETS
TRAIN_SCHEDULE = "wsd"


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36, n_kv=36,
        d_ff=5760, vocab=122753, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", n_layers=3, d_model=72, n_heads=6, n_kv=6,
        d_ff=192, vocab=509, **SMOKE)   # odd vocab on purpose (pad paths)
