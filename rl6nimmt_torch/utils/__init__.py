"""Device resolution and index helpers."""
