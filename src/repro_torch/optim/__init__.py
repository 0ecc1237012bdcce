"""Optimizers of the port: AdamW with LR schedules and clipping, and the
parameter EMA."""
