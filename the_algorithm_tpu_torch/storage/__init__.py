"""Storage substrate: tweet source-of-truth store (tweetypie analog)."""
