"""One reader a metric, ``<metric>.py``: ``read(run)`` returns the metric's
value from the run's state (``cell.Run``), or None where the run has
nothing for it to read, and the harness then leaves the metric out."""
