"""Utilities (port of repro.utils)."""
