"""Model zoo of the port (counterpart: ``src/repro/models/``): the
configuration, the parameter tree, the layers and the transformer stack.
This slice runs attention-only dense decoders (Qwen2-1.5B)."""
