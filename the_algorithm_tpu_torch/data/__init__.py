"""Synthetic data builders."""
