"""Models: the serving decoder and its layers."""
