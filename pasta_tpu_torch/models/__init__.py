"""Models of the port."""

from .generator import Generator, SynthesisNetwork

__all__ = ["Generator", "SynthesisNetwork"]
