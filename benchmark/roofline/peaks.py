"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
power limit); a card set below it (``nvidia-smi`` power.limit, printed by
every run) reaches less."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
