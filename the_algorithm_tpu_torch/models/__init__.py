"""Model families: the MaskNet heavy ranker."""
