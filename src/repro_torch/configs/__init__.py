"""Architecture registry of the port: the dense decoders (tied and untied
output heads) and Mamba-2 (serving only).  Each module exports ``ARCH``,
``full()`` (the published config), ``smoke()`` (the reduced CPU-test
config) and ``PEFT_TARGETS``, as the JAX package's config modules do.
The other architectures are queued in ROADMAP.md."""

from __future__ import annotations

import importlib

from repro_torch import NotPortedError

ARCH_IDS = ["smollm_360m", "paper_llama2_7b", "mamba2_1p3b", "qwen2p5_32b",
            "deepseek_coder_33b", "minicpm_2b"]

# CLI-friendly aliases → module names
ALIASES = {
    "smollm-360m": "smollm_360m",
    "llama-2-7b": "paper_llama2_7b",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen2.5-32b": "qwen2p5_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minicpm-2b": "minicpm_2b",
}


def get_module(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in ARCH_IDS:
        raise NotPortedError(f"architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str, variant: str = "full"):
    if variant not in ("full", "smoke"):
        raise ValueError(f"variant must be 'full' or 'smoke', got "
                         f"{variant!r}")
    m = get_module(arch)
    return m.full() if variant == "full" else m.smoke()


def peft_targets(arch: str) -> str:
    return get_module(arch).PEFT_TARGETS
