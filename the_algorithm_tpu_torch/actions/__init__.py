"""User-action plumbing: UUA normalization and enrichment (host copies)."""
