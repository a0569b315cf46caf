"""Decoder layers: norms, rotary embeddings, attention."""
