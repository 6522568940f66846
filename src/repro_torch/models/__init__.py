"""Model layers, attention and the layered LM."""
