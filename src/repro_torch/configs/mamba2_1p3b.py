"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]
ETHER attaches to in_proj / out_proj (conv/Δ/A/D have no d×f structure
and stay frozen; DESIGN.md §5).  The port serves it; training an ``ssd``
config raises NotPortedError (ROADMAP.md).
"""

from repro_torch.configs._common import FULL, SMOKE, SSM_TARGETS
from repro_torch.models.backbone import ModelConfig

ARCH = {"id": "mamba2-1.3b", "family": "ssm",
        "long_500k": True, "decode": True}
PEFT_TARGETS = SSM_TARGETS


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=1, n_kv=1,
        d_ff=0, vocab=50280, block_pattern=("ssd",), mlp_type="none",
        rope_theta=None, ssm_headdim=64, ssm_state=128, ssm_expand=2,
        ssm_groups=1, ssm_chunk=256, **FULL)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", n_layers=3, d_model=64, n_heads=1, n_kv=1,
        d_ff=0, vocab=256, block_pattern=("ssd",), mlp_type="none",
        rope_theta=None, ssm_headdim=16, ssm_state=16, ssm_chunk=8,
        **SMOKE)
