"""Device and platform helpers."""
