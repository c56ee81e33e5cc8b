"""Fault-tolerant checkpoints of the training state (``manager``)."""
