"""Architecture and shape configuration dataclasses."""
