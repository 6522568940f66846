"""Model zoo: one layered LM covering all ten configs, with its layers,
attention, MoE, Mamba and xLSTM mixers."""
from repro_torch.models import transformer, attention, moe, mamba, xlstm, \
    layers
