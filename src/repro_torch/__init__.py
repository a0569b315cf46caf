"""PyTorch and CUDA port of the MicroEP/MicroMoE reproduction (reference: ``repro``)."""
