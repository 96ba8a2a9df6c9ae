"""The benchmark harness of the port (see ``benchmark/run.py``)."""
