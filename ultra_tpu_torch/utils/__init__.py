"""Checkpoint interop."""
