from repro_torch.kernels.cluster_score.group import group_slots_ref
from repro_torch.kernels.cluster_score.ops import cluster_score
from repro_torch.kernels.cluster_score.ref import cluster_score_ref

__all__ = ["cluster_score", "cluster_score_ref", "group_slots_ref"]
