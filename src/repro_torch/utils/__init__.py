"""Device resolution, the numpy bridge and the JAX-to-port converters."""
