"""Version of the port (the JAX package's version string)."""

version = "0.1.0"
__version__ = version
