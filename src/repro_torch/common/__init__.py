"""Small helpers shared across the port (the JAX package's
`repro.common` counterparts)."""
