"""The benchmark's machinery: registry, traffic, weights, tracing, checks."""
