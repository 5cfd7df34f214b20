"""PyTorch/CUDA port of the ETHER system for one NVIDIA H100.

Mirrors ``repro``'s subpackage and module names so each port module sits
where its JAX counterpart does.  Imports ``torch`` and numpy only, never
``jax`` nor ``repro``.  Public functions keep the JAX package's layouts:
kernels are stored (d_in, d_out), layers are stacked on a leading axis,
the KV cache is (L, B, Hkv, T, D) and logits are (B, 1, V) float32.

What is ported so far, on the dense decoders and one device: serving
(``launch/serve.py``, unmerged, ``--merged`` and from a multi-tenant
adapter bank with ``--tenants``) and training
(``launch/train.py``, ``runtime/trainer.py``) with every method of the
JAX registry but VeRA.  ETHER runs on the hand-written CUDA kernels
``householder_gemm``, ``ether_merge``, ``reflect_gemm_dx`` and
``reflect_gemm_dw``; ETHER+ on ``etherplus_gemm``, ``etherplus_merge``,
``etherplus_reflect_bwd`` and the rank-2 dx/dw; DeLoRA on
``delora_gemm`` and ``delora_merge``; HyperAdapt on ``hyperadapt_gemm``
and ``hyperadapt_merge`` (``csrc/``); bank serving on their batched
kernels ``householder_gemm_batched``, ``etherplus_reflect_batched``,
``delora_gemm_batched`` and ``hyperadapt_gemm_batched``; the registry's
standalone reflections ``ether_reflect`` and ``ether_reflect_batched``
on kernels of the same names and their backwards, all through
``core.execute.dispatch``, differentiable on every backend.  OFT, Naive,
LoRA and full finetuning are plain PyTorch, as the JAX package runs them
in jnp.
Everything else is queued in ROADMAP.md.
"""


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to repro_torch; "
                         f"see ROADMAP.md")
