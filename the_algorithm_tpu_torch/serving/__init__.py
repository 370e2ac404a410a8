"""Serving edge: dynamic batching, versioned model hot-swap, HTTP front."""
