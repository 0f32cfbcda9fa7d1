"""Host and device stages of the serving path, and synthetic records."""
