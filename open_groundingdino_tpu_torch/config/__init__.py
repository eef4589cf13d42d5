"""Configuration loading (the port's own copy of the JAX package's config/)."""
from .slconfig import SLConfig  # noqa: F401
