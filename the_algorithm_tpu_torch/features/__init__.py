"""Feature stores: aggregates, graph features, user signals, RSX similarities."""
