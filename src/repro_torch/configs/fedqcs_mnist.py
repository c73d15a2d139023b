"""The paper's own experiment config (Sec. VI): 784-20-10 MLP, K=30 non-IID
devices, Adam(lr=0.003), (R,Q)=(3,3), S_ratio=0.1, B=10 blocks."""
from repro_torch.core.compression import FedQCSConfig

K_DEVICES = 30
N_BAR = 15_910  # 784*20 + 20 + 20*10 + 10
N_BLOCKS = 10
BLOCK_SIZE = 1591
LR = 0.003

FED_CONFIG = FedQCSConfig(
    block_size=BLOCK_SIZE,
    reduction_ratio=3,
    bits=3,
    s_ratio=0.1,
    gamp_iters=25,
)
