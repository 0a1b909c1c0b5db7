"""Model stacks over the tiled executor."""
