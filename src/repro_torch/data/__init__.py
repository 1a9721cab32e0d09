"""The synthetic token pipeline of the training path (the port of the
reference's `repro/data`)."""
