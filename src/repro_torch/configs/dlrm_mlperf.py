"""dlrm-mlperf [recsys] — MLPerf DLRM benchmark config (Criteo 1TB).

[arXiv:1906.00091; paper] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
Table sizes are the standard Criteo-1TB cardinalities used by MLPerf.

(A copy of repro.configs.dlrm_mlperf.)
"""

from repro_torch.configs.base import RecsysConfig

# MLPerf / Criteo Terabyte categorical cardinalities (26 tables, ~188M rows).
CRITEO_1TB_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def full() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-mlperf", kind="dlrm",
        n_dense=13, n_sparse=26, embed_dim=128,
        table_sizes=CRITEO_1TB_TABLE_SIZES,
        bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
        interaction="dot",
    )


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-mlperf-smoke", kind="dlrm",
        n_dense=13, n_sparse=6, embed_dim=16,
        table_sizes=(1000, 200, 50, 1000, 31, 7),
        bot_mlp=(32, 16),
        top_mlp=(64, 32, 1),
        interaction="dot",
    )
