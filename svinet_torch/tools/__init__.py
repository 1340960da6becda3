"""Measurement scripts of the port, run on a machine with the GPU:

    python -m svinet_torch.tools.bench_kernels     kernel designs side by side
    python -m svinet_torch.tools.profile_stretch   where a stretch step goes
    python -m svinet_torch.tools.time_report       one report's community
                                                   extraction, timed
    python -m svinet_torch.tools.locality_order    -mesh-locality's node
                                                   order and layout, timed
"""
