"""Compute ops: sparse embeddings, run-collapse, row gather, retrieval."""
