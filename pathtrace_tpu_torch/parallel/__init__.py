"""Multi-device rendering (``shard.py``), on ``torch.distributed``."""
