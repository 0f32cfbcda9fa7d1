"""Models of the port."""

from .discriminator import Discriminator
from .generator import Generator, SynthesisNetwork
from .patch_discriminator import PatchCoOccurrenceDiscriminator

__all__ = ["Discriminator", "Generator", "PatchCoOccurrenceDiscriminator",
           "SynthesisNetwork"]
