"""Multi-GPU data parallelism on torch.distributed (svinet_tpu/parallel/)."""
