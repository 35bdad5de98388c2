"""PyTorch port of raft_stereo_tpu for NVIDIA GPUs (CUDA kernels for Hopper)."""
