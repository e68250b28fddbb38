"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2.
"""

from repro_torch.configs.base import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        moe=True, n_experts=128, moe_top_k=2, moe_d_ff=4864,
        dense_residual=True,
        rope_theta=1e6,
        # 480B params: bfloat16 params and optimizer state
        param_dtype="bfloat16", opt_state_dtype="bfloat16",
        logits_chunk=2048, microbatch=8,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=256,
        moe=True, n_experts=8, moe_top_k=2, moe_d_ff=96,
        dense_residual=True, param_dtype="float32", dtype="float32",
    )
