"""Model layers, attention and the layered LM."""
from repro_torch.models import transformer, attention, layers
