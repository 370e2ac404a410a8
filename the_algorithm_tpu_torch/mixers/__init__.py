"""The For You product: the wide feature schema, device hydration, the batched engine."""
