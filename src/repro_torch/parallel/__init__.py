"""Logical-axis sharding rules on the virtual mesh (``repro/parallel``)."""
