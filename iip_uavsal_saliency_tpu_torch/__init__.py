"""UAVSal in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `iip_uavsal_saliency_tpu` (JAX/TPU), which stays the reference.
The module layout mirrors it (`ops/`, `models/`, `serving/`, `runners/`,
`data/`, `training/`) and public functions keep its layouts: frames
(V, S, H, W, 3), TWA state (V, H/8, W/8, C), saliency (V, S, H/8, W/8, 1).
Entry points run on CUDA unless the caller passes `device="cpu"`.
"""
