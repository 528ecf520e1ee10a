"""Accuracy metrics, timing and checkpoints of the port."""
