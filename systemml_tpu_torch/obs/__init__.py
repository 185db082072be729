"""Observability of the PyTorch port: the event bus (``obs.trace``) and
the typed metrics registry (``obs.metrics``), copied from the JAX
package. The exporters, the profiler and the fleet views wait
(ROADMAP queue 1, observability)."""
