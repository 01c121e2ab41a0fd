"""Serving and training entry points of the port's language models."""
