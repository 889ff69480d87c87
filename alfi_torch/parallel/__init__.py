"""Distributed execution of the almg solve on ``torch.distributed``: the
host decomposition (``decompose``), the rank group and its reductions
(``sharding``), the distributed solver (``distributed``) and spawned rank
groups with the multi-rank dryrun (``dryrun``)."""

from .sharding import RankGroup, make_rank_group  # noqa: F401
