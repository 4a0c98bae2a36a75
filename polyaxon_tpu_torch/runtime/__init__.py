"""Runtimes of the port: the builtin training entry (``builtin.py``)."""
