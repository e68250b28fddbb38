"""qwen2.5-32b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.configs.base import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
        logits_chunk=2048, microbatch=8,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-32b-smoke",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
        d_ff=192, vocab_size=256,
        qkv_bias=True, head_dim=16, param_dtype="float32", dtype="float32",
    )
