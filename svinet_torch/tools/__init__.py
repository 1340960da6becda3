"""Measurement scripts of the port, run on a machine with the GPU:

    python -m svinet_torch.tools.bench_kernels     kernel designs side by side
    python -m svinet_torch.tools.profile_stretch   where a stretch step goes
"""
