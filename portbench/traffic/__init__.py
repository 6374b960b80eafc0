"""Traffic mixes: one JSON file of parameters each, read by ``generator``."""
