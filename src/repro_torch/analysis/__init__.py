"""The dry run's analysis: per-rank cost counting, the roofline and the
collective breakdown (the JAX package's `repro.analysis`)."""
