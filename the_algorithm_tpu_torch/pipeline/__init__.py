"""The product-mixer data model (the candidate record)."""
