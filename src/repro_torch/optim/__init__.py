"""Optimizers, learning-rate schedules and the trainer's int8 error feedback."""
