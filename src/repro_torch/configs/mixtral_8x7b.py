"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096.
"""

from repro_torch.configs.base import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        moe=True, n_experts=8, moe_top_k=2, moe_d_ff=14336,
        sliding_window=4096,
        rope_theta=1e6,
        logits_chunk=2048, microbatch=8,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        moe=True, n_experts=4, moe_top_k=2, moe_d_ff=128,
        sliding_window=16, param_dtype="float32", dtype="float32",
    )
