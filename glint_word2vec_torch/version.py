"""The port's version: the JAX package's version string, since the two
packages give the same capabilities."""

__version__ = "0.2.0"
