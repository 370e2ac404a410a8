"""Training runtime: model-quality metrics."""
