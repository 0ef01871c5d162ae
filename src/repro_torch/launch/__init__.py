"""Training runtime."""
