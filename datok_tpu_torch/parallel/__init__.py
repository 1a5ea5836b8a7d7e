"""Lanes over several devices, and corpus runs over several processes."""
