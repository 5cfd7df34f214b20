"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256, llama-arch, untied output head.
[arXiv:2401.14196; hf]
long_500k SKIPPED (full attention).
"""

from repro_torch.configs._common import DENSE_TARGETS, FULL, SMOKE
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "deepseek-coder-33b", "family": "dense",
        "long_500k": False, "decode": True}
PEFT_TARGETS = DENSE_TARGETS


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
        n_kv=8, d_ff=19200, vocab=32256, rope_theta=100_000.0,
        tie_embeddings=False, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", n_layers=3, d_model=112, n_heads=7, n_kv=1,
        d_ff=320, vocab=512, tie_embeddings=False, **SMOKE)
