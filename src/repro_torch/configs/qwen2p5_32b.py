"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, GQA + QKV bias, rope θ 1e6, untied output head
[hf:Qwen/Qwen2.5-32B config.json: num_hidden_layers 64, hidden_size 5120,
num_attention_heads 40, num_key_value_heads 8, intermediate_size 27648,
vocab_size 152064, rope_theta 1000000.0, tie_word_embeddings false].
long_500k SKIPPED (full attention).
"""

from repro_torch.configs._common import DENSE_TARGETS, FULL, SMOKE
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "qwen2.5-32b", "family": "dense",
        "long_500k": False, "decode": True}
PEFT_TARGETS = DENSE_TARGETS


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv=8,
        d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
        tie_embeddings=False, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", n_layers=3, d_model=80, n_heads=5, n_kv=1,
        d_ff=256, vocab=512, qkv_bias=True, tie_embeddings=False, **SMOKE)
