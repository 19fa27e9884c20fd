"""Entry points (the batched server so far)."""
