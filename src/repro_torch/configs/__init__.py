"""Architecture configs of the port (data copied from ``src/repro/configs``)."""
