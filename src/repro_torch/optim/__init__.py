"""Optimizer and learning-rate schedules."""
