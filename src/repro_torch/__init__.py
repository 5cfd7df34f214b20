"""PyTorch/CUDA port of the ETHER system for one NVIDIA H100.

Mirrors ``repro``'s subpackage and module names so each port module sits
where its JAX counterpart does.  Imports ``torch`` and numpy only, never
``jax`` nor ``repro``.  Public functions keep the JAX package's layouts:
kernels are stored (d_in, d_out), layers are stacked on a leading axis,
the KV cache is (L, B, Hkv, T, D) and logits are (B, 1, V) float32.

What is ported so far: ETHER serving of the dense decoders
(``launch/serve.py``), with every adapted linear on the hand-written
``householder_gemm`` CUDA kernel and ``--merged`` on the ``ether_merge``
CUDA kernel, and ETHER training on one device (``launch/train.py``,
``runtime/trainer.py``), whose backward of every adapted linear runs the
``reflect_gemm_dx`` kernel (and ``reflect_gemm_dw`` where a weight
trains) (``csrc/``).  Everything else is queued in ROADMAP.md.
"""


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that the port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to repro_torch; "
                         f"see ROADMAP.md")
