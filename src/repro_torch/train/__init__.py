"""The training step on one device."""
