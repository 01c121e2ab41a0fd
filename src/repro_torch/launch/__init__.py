"""Serving entry points of the port's language models."""
