"""Layers and initializers of the pure-functional substrate (``{"w", "b"}``
dicts of tensors, the reference's layouts)."""
