"""Run configuration (the trainer's part of the reference's configs)."""
