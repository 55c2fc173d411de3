"""The port's version, its own copy of the JAX package's ``version.py``."""

__version__ = "0.1.0"
