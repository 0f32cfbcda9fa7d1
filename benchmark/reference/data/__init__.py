"""Host and device stages of the reference try-on path."""
