"""wide-deep [recsys] — wide linear branch + deep MLP. [arXiv:1606.07792]

n_sparse=40 embed_dim=32 mlp=1024-512-256 interaction=concat.
Google-Play-scale cardinalities: a few huge id vocabs (user/app ids),
mid-size categorical, and small demographic fields.

(A copy of repro.configs.wide_deep.)
"""

from repro_torch.configs.base import RecsysConfig

WIDE_DEEP_TABLE_SIZES = (
    # huge id spaces
    10_000_000, 10_000_000, 1_000_000, 1_000_000,
    # mid categorical
    100_000, 100_000, 50_000, 50_000, 10_000, 10_000, 10_000, 10_000,
    5_000, 5_000, 2_000, 2_000, 1_000, 1_000, 1_000, 1_000,
    # small demographic / device fields
    500, 500, 200, 200, 100, 100, 100, 100, 50, 50,
    40, 40, 30, 30, 20, 20, 10, 10, 5, 5,
)


def full() -> RecsysConfig:
    return RecsysConfig(
        name="wide-deep", kind="wide_deep",
        n_dense=0, n_sparse=40, embed_dim=32,
        table_sizes=WIDE_DEEP_TABLE_SIZES,
        mlp=(1024, 512, 256),
        interaction="concat",
    )


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="wide-deep-smoke", kind="wide_deep",
        n_dense=0, n_sparse=6, embed_dim=8,
        table_sizes=(2000, 500, 100, 50, 10, 5),
        mlp=(32, 16),
        interaction="concat",
    )
