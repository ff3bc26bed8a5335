"""Models."""
