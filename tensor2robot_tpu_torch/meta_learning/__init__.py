"""Meta-learning data layout: task×sample batches and MetaExample specs."""
