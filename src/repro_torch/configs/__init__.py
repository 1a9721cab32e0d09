"""Configurations the port runs: the paper's simulated SSD."""
