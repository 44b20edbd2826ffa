"""Serving observability of the port: the metrics registry
(``metrics.py``) and per-request spans (``tracing.py``), stdlib-only
copies of the JAX package's modules."""
