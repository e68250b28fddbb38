"""nequip [gnn] — O(3)-equivariant interatomic potential. [arXiv:2101.03164]

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor products.
Non-molecular graph shapes (citation / product graphs) carry no physical
coordinates; their batches get synthetic 3-D positions so the
equivariant machinery runs unchanged.
"""

from repro_torch.configs.base import NequIPConfig


def full() -> NequIPConfig:
    return NequIPConfig(
        name="nequip",
        n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0,
        n_species=32,
    )


def smoke() -> NequIPConfig:
    return NequIPConfig(
        name="nequip-smoke",
        n_layers=2, d_hidden=8, l_max=2, n_rbf=4, cutoff=5.0,
        n_species=8,
    )
