"""Layers, mapping, encoders and synthesis blocks of the reference."""
