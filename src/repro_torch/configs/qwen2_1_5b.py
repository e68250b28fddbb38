"""qwen2-1.5b [dense] — GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""

from repro_torch.configs.base import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6,
        logits_chunk=2048, microbatch=4,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        qkv_bias=True, param_dtype="float32", dtype="float32",
    )
