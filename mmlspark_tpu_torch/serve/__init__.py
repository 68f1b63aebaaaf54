"""Online serving: ModelServer over per-model dynamic batchers."""
