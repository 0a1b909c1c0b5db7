"""Operational drivers (serving loop + watchdog)."""
