"""Models of the port."""

from .discriminator import Discriminator
from .generator import Generator, SynthesisNetwork

__all__ = ["Discriminator", "Generator", "SynthesisNetwork"]
