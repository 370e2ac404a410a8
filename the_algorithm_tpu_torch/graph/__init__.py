"""Engagement graphs: UTEG traversal, GraphJet related tweets and user-user recs."""
