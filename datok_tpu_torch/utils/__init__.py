"""Utilities: native library loading, stats."""
