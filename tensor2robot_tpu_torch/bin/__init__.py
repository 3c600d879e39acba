"""Binaries."""
