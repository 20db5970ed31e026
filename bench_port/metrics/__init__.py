"""Per-layer metric readers, one module each, found by the metric's name:
``read(run)`` returns the metric's value from the run's host-clock call
times, shapes and reduced trace, or None where it finds nothing to
read."""
