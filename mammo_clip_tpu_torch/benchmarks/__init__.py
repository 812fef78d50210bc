"""Card probes (ports of the JAX package's ``benchmarks/probe_*.py``)."""
