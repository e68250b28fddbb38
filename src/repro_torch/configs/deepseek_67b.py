"""deepseek-67b [dense] — llama-arch GQA kv=8. [arXiv:2401.02954; hf]

Also used as the RepLLaMA-style LLM dense-retrieval encoder in the CluSD
Table-5 benchmark (high-dimension corpus embeddings).
"""

from repro_torch.configs.base import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=102400,
        rope_theta=1e4,
        logits_chunk=2048, microbatch=16,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b-smoke",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab_size=256, param_dtype="float32", dtype="float32",
    )
