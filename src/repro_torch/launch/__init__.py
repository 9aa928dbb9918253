"""Launchers of the port (mirrors ``src/repro/launch``)."""
