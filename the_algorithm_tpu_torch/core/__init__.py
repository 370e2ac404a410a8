"""Core runtime: host-side metrics (the StatsReceiver analog) and feature hashing."""
