"""Tweet search: the Earlybird realtime index scan, relevance scoring, SuperRoot."""
