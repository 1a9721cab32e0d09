"""Checkpoints of the training path (the port of the reference's
`repro/checkpoint`)."""
