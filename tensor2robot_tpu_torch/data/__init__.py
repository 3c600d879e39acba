"""Input generators: the spec-driven sources of training batches."""
