"""vfl-recsys — the paper's own demo workload (Stalactite §4).

A two-party vertical split over an SBOL-like dataset (190 439 users,
19 banking products, 1 345 extra user features) joined with a
MegaMarket-like feature silo. The master holds labels + its feature
slice; the member holds the second silo's features. Models: VFL
logistic regression (arbitered + arbiterless) and a split-NN
recommender. Data is generated synthetically with the published
statistics (Table 1) since the real datasets are not redistributable.
"""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VFLRecsysConfig:
    arch_id: str = "vfl-recsys"
    source: str = "Stalactite (RecSys'24), Table 1 + §4"
    # SBOL statistics (Table 1)
    n_users: int = 190_439
    n_items: int = 19
    n_interactions: int = 1_056_889
    n_other_features: int = 1_345
    # vertical split: master silo (SBOL) + member silos (MegaMarket-like)
    n_parties: int = 2
    # fraction of master users present in each member silo (ID overlap)
    id_overlap: float = 0.6
    member_features: Tuple[int, ...] = (381,)   # MegaMarket-like silo width
    # split-NN dims — DEPRECATED: these layer-width tuples predate the
    # TowerSpec model factory (repro_torch.models.tower, DESIGN.md §12). They
    # keep working through bottom_tower()/top_tower() below, which map
    # them onto an equivalent one-block MLP tower (warns once).
    bottom_dims: Tuple[int, ...] = (256, 128)
    top_dims: Tuple[int, ...] = (128, 64)
    embedding_dim: int = 128

    def bottom_tower(self, in_dim: int):
        """Deprecated ``bottom_dims`` as an equivalent MLP
        :class:`~repro_torch.models.tower.TowerSpec` mapping ``in_dim``
        features to ``embedding_dim`` (bit-identical params/math to
        the legacy ``mlp_init``/``mlp_apply`` path)."""
        from repro_torch.models.tower import legacy_dims_tower
        return legacy_dims_tower(
            (int(in_dim),) + tuple(self.bottom_dims[:-1])
            + (self.embedding_dim,), final_act=True)

    def top_tower(self):
        """Deprecated ``top_dims`` as an equivalent MLP
        :class:`~repro_torch.models.tower.TowerSpec` mapping the summed
        ``embedding_dim`` to ``n_items`` logits (no final activation,
        as the legacy top model)."""
        from repro_torch.models.tower import legacy_dims_tower
        return legacy_dims_tower(
            (self.embedding_dim,) + tuple(self.top_dims)
            + (self.n_items,), final_act=False)

    def reduced(self) -> "VFLRecsysConfig":
        """CI-sized variant for smoke tests."""
        return VFLRecsysConfig(
            n_users=512, n_items=19, n_interactions=4_096,
            n_other_features=64, member_features=(32,),
            bottom_dims=(32, 16), top_dims=(16, 8), embedding_dim=16)


CONFIG = VFLRecsysConfig()
