"""Decoder layers: norms, rotary embeddings, attention, dense FFNs, RWKV-6."""
