"""Harnesses over the port: ``chaos`` runs seeded fault campaigns over its
serving runtime (``python -m raft_stereo_tpu_torch.tools.chaos``)."""
