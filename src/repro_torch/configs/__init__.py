"""Run and architecture configuration (``repro/configs``)."""
