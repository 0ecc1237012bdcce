"""Checkpointing of the port (the reference's on-disk layout)."""
