"""Parameter initialisation and evaluation helpers."""
