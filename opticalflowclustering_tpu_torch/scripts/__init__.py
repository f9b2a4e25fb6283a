"""Scripts that run on the card: the gather-cost probes and their clips."""
