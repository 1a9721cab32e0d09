"""The hybrid-SSD simulator: config, policy engine, single-cell and fleet
drivers."""
