"""Query-path and build-side numerics of the port (batched over queries,
one module per module of repro.core)."""
