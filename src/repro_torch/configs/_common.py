"""Shared config helpers."""

DENSE_TARGETS = "q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj"
SSM_TARGETS = "in_proj|out_proj"

FULL = dict(param_dtype="bfloat16", compute_dtype="bfloat16",
            remat="full", loss_chunk=512, q_chunk=512)
SMOKE = dict(param_dtype="float32", compute_dtype="float32",
             remat="none", loss_chunk=0, q_chunk=128)
