"""deepfm [recsys] — FM branch + deep MLP. [arXiv:1703.04247; paper]

n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm.
Criteo display-ads style cardinalities (39 fields: 13 bucketized-dense +
26 categorical, all embedded per the DeepFM paper's formulation).

(A copy of repro.configs.deepfm.)
"""

from repro_torch.configs.base import RecsysConfig

# 13 bucketized numeric fields (small vocabs) + 26 categorical fields.
DEEPFM_TABLE_SIZES = tuple([64] * 13) + (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


def full() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm", kind="deepfm",
        n_dense=0, n_sparse=39, embed_dim=10,
        table_sizes=DEEPFM_TABLE_SIZES,
        mlp=(400, 400, 400),
        interaction="fm",
    )


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm-smoke", kind="deepfm",
        n_dense=0, n_sparse=8, embed_dim=8,
        table_sizes=(64,) * 4 + (500, 100, 1000, 13),
        mlp=(32, 32),
        interaction="fm",
    )
