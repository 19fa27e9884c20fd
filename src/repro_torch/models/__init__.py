"""The model execution plane: parameter specs, blocks, the per-arch
registry and the model assembly (the dense text family so far)."""
