"""din [recsys] — Deep Interest Network, target attention over behavior
sequence. [arXiv:1706.06978; paper]

embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80 interaction=target-attn.
Amazon-Books-style cardinalities: item id, category id (behavior and target
share tables), plus user-profile fields.

(A copy of repro.configs.din.)
"""

from repro_torch.configs.base import RecsysConfig

# tables: [item_id, cate_id, user_id, age_bucket, gender]
DIN_TABLE_SIZES = (371530, 1601, 543060, 8, 3)


def full() -> RecsysConfig:
    return RecsysConfig(
        name="din", kind="din",
        n_dense=0, n_sparse=5, embed_dim=18,
        table_sizes=DIN_TABLE_SIZES,
        mlp=(200, 80),
        attn_mlp=(80, 40),
        seq_len=100,
        interaction="target-attn",
    )


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="din-smoke", kind="din",
        n_dense=0, n_sparse=5, embed_dim=8,
        table_sizes=(1000, 50, 500, 8, 3),
        mlp=(32, 16),
        attn_mlp=(16, 8),
        seq_len=12,
        interaction="target-attn",
    )
