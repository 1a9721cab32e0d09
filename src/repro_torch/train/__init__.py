"""The training step (the port of the reference's `repro/train`)."""
