"""Graph passes over Symbol DAGs: the block-fusion planner
(:mod:`.fusion`)."""
