"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (see ``build.py`` for how they are built)."""
from . import block_topk, samomentum_kernel, scatter_apply, wire_pack

KERNELS = (scatter_apply.INFO, block_topk.INFO, samomentum_kernel.INFO,
           scatter_apply.ROWS_INFO, wire_pack.INFO, wire_pack.PACK_INFO,
           samomentum_kernel.ACC_INFO, samomentum_kernel.FMA_INFO,
           block_topk.ROW_INFO, block_topk.SAM_ROW_INFO,
           block_topk.SAM_SEG_INFO, block_topk.SAM_COL_INFO)


def reset_launches() -> None:
    for info in KERNELS:
        info.launches = 0
