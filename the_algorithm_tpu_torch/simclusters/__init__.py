"""SimClusters v2: the ANN retrieval service."""
